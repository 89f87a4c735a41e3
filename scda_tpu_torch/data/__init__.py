"""Data layer: dataset registry, fixed-shape pipeline, fixtures.

Importing the package activates every dataset family's registrations
(ref lib/datasets/factory.py imports all imdb modules at module scope).
"""

from scda_tpu_torch.data import cityscapes as _cityscapes  # noqa: F401 (*_raw_*)
from scda_tpu_torch.data import coco as _coco  # noqa: F401  (registers coco_*)
from scda_tpu_torch.data import imagenet as _imagenet  # noqa: F401 (imagenet_det_*)
from scda_tpu_torch.data import vg as _vg      # noqa: F401  (registers vg_*)
from scda_tpu_torch.data import voc as _voc    # noqa: F401  (registers VOC sets)
