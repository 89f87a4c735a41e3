"""Plain f32 PyTorch reference of the benchmark's detectors and steps:
imports nothing of the program or of JAX.

A configuration names its reference module with ``"reference":
"<module>"`` in ``benchmark/configs/<name>.json``: this directory's
``<module>.py``, ``steps`` where it names none.  ``harness/spec.py``
loads it as ``cell.reference``; the output check (``harness/judge.py``),
its controls (``harness/control.py``) and the training driver
(``harness/kinds/train.py``) call nothing else of it.  A reference
module provides, with ``steps.py``'s signatures and records:

* ``serve(P, image, im_info, cfg, prec, proposals=None)``: one served
  batch from the weights ``P``; a dict whose ``calls`` (the proposal
  layer's calls, each ((rpn_cls, rpn_bbox, anchors, im_info, proposal
  config), proposals)), ``head`` (the RoI head's class logits and box
  deltas) and ``dets`` (boxes, scores, classes, valid) the harness reads;
* ``train_steps(P0, D0, batches, cfg, prec, seed, steps, proposals=None,
  step0=0, momentum=None, d_momentum=None)``: steps from ``P0`` (and the
  discriminator's ``D0``, or None); a dict with ``metrics`` (a dict a
  step, ``loss`` among them), ``calls`` (each step's proposal calls),
  ``first_grad`` (where ``momentum`` is None), ``last_grad``, ``params``
  (the trainable leaves after the last step, the discriminator's as
  ``D.<name>``), ``momentum`` and, with ``D0``, ``d_momentum``;
* ``trainable_names(P, model_cfg)``: the leaves the step trains;
* ``doubled_biases(P, names, train_cfg)``: those whose gradient the
  optimizer doubles;
* ``first_gradient(momentum, doubled)``: the first step's gradient as the
  optimizer took it in, from its momentum after that step.

``detect.py``'s proposal layer (``propose``) and postprocess
(``class_boxes``, ``postprocess``) stay shared by every reference: the
check follows the program through them, on the program's own inputs
(``judge.py``), so they are part of the yardstick and not of a model.
"""
