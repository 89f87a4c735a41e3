"""The training optimizer's chain in one pass: the CUDA kernel and its
plain twin.

Replaces no TPU kernel: the JAX package's optimizer is optax's chain,
which XLA fuses into the step's program.  The port's chain
(:class:`scda_tpu_torch.train.state.SgdChain`, and the discriminator's
plain SGD beside it in the SCDA step) is, per trainable tensor:

    clip by the global norm, add weight decay, double a bias gradient,
    trace = g + momentum * trace (the product in the trace's dtype),
    p = p + trace * (-lr)

:func:`sgd_chain_plain` runs it eagerly, as the CPU does: about 750
launches a ResNet-101 step and some 24 passes over the f32 parameters.
:func:`sgd_chain` launches ``csrc/sgd_chain.cu``: the norm's partial sums
(one fixed slot a block, no atomics), their sum in a fixed order by one
block, then one update over every tensor, three launches in all.  A
launch holds the gradient pointers of ``MAX_TENSORS`` tensors, more than
any configuration trains (113 at most: VGG16 with the SCDA
discriminator); more are refused.  The host never waits: the clip's
divisor and factor stay in device memory.  Each element takes the eager
chain's operations in its order, each rounded on its own, so the result
equals the twin's bit for bit where the norm stays under the clip; where
the clip engages, the norm's summation order differs (f64 partials here,
per-tensor f32 sums there).

The kernel's tables (:class:`SgdTables`: each tensor's pointers, size,
decay, bias factor and flags; the chunk map; the norm's scratch) are
built once: parameters and momenta are updated in place and never move.
The gradients' pointers go in as kernel parameters every step; a
gradient that does not lie in memory as its parameter does is copied to
that layout first, into a buffer made once.  Nothing is allocated in a
step after the first.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from scda_tpu_torch.ops.kernels import _build

# ``csrc/sgd_chain.cu``: elements a block takes, and gradient pointers a
# launch holds in its parameters.
CHUNK = 16384
MAX_TENSORS = 400

# Bits of ``TensorEntry::flags``.
_CLIP, _BF16, _PLAIN = 1, 2, 4

_ENTRY = np.dtype([("p", "<u8"), ("m", "<u8"), ("n", "<i8"),
                   ("decay", "<f4"), ("scale", "<f4"), ("flags", "<i4"),
                   ("pad", "<i4")])


class SgdRule(NamedTuple):
    """What the chain does to one tensor."""

    clip: bool      # in the global norm, and scaled by the clip
    decay: float    # weight decay coefficient; 0.0: none
    scale: float    # the gradient's factor after decay: 2.0 for a doubled bias
    group: int      # 0: the detector's momentum and rate; 1: the plain group's


class Plan(NamedTuple):
    """The kernel's work over tensors of ``numels`` elements: one chunk of
    up to ``CHUNK`` elements a block, in tensor order."""

    chunks: List[Tuple[int, int]]      # (tensor, chunk of the tensor)
    clipped: int                       # tensors in the norm, a prefix
    clip_chunks: int                   # the norm's partial sums


def plan(numels: Sequence[int], rules: Sequence[SgdRule]) -> Plan:
    """The chunks of the kernel over tensors of ``numels`` elements.  The
    clipped tensors must come first: the norm's partial sums fill slots
    0 .. ``clip_chunks``."""
    if len(numels) > MAX_TENSORS:
        raise ValueError(f"sgd_chain: {len(numels)} tensors; a launch holds "
                         f"{MAX_TENSORS}")
    clipped = sum(r.clip for r in rules)
    if any(r.clip for r in rules[clipped:]):
        raise ValueError("sgd_chain: the clipped tensors must come first")
    chunks: List[Tuple[int, int]] = []
    clip_chunks = 0
    for t, n in enumerate(numels):
        chunks.extend((t, k) for k in range(-(-int(n) // CHUNK)))
        if t < clipped:
            clip_chunks = len(chunks)
    return Plan(chunks, clipped, clip_chunks)


def _dense(t: torch.Tensor) -> bool:
    """Its elements fill ``numel`` slots from its pointer on, each once,
    in some order of the dimensions."""
    dims = sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1)
    expect = 1
    for s, n in dims:
        if s != expect:
            return False
        expect *= n
    return True


def _same_layout(g: torch.Tensor, p: torch.Tensor) -> bool:
    return g.shape == p.shape and all(
        a == b for a, b, n in zip(g.stride(), p.stride(), p.shape) if n != 1)


class SgdTables:
    """The kernel's tables over fixed ``params`` and ``momenta`` (CUDA,
    one device; parameters float32, each momentum float32 or bfloat16
    with its parameter's shape and strides) and their ``rules``, with the
    norm's scratch.  ``clip`` is the global norm's bound, None for no
    clipping.  Holds the tensors, so their memory is not reused while the
    tables point at it."""

    def __init__(self, params: Sequence[torch.Tensor],
                 momenta: Sequence[torch.Tensor], rules: Sequence[SgdRule],
                 clip: Optional[float]):
        if not (len(params) == len(momenta) == len(rules)) or not params:
            raise ValueError("sgd_chain: needs one momentum and one rule a "
                             f"parameter, got {len(params)}, {len(momenta)}, "
                             f"{len(rules)}")
        device = params[0].device
        if device.type != "cuda":
            raise ValueError(f"sgd_chain: parameters on {device}; the kernel "
                             "needs CUDA tensors")
        for name, mine in (("scda_sgd_chunk", CHUNK),
                           ("scda_sgd_max_tensors", MAX_TENSORS)):
            theirs = _build.function(name, [], ctypes.c_longlong)()
            if theirs != mine:
                raise RuntimeError(f"sgd_chain: {name}() is {theirs} in the "
                                   f"library, {mine} here")
        self.plan = plan([p.numel() for p in params], rules)
        if self.plan.clipped and clip is None:
            raise ValueError("sgd_chain: clipped tensors need a clip")
        table = np.zeros(len(params), dtype=_ENTRY)
        for i, (p, m, r) in enumerate(zip(params, momenta, rules)):
            if p.device != device or m.device != device:
                raise ValueError(f"sgd_chain: tensor {i} is not on {device}")
            if p.dtype != torch.float32 or m.dtype not in (torch.float32,
                                                           torch.bfloat16):
                raise TypeError(f"sgd_chain: tensor {i}: needs a float32 "
                                f"parameter and a float32 or bfloat16 "
                                f"momentum, got {p.dtype} and {m.dtype}")
            if not (_dense(p) and _same_layout(m, p)):
                raise ValueError(f"sgd_chain: tensor {i}: the parameter must "
                                 "be dense and its momentum laid out as it is")
            table[i] = (p.data_ptr(), m.data_ptr(), p.numel(), r.decay,
                        r.scale, (_CLIP if r.clip else 0)
                        | (_BF16 if m.dtype == torch.bfloat16 else 0)
                        | (_PLAIN if r.group else 0), 0)
        self.device = device
        self.params, self.momenta = list(params), list(momenta)
        self.rules = list(rules)
        self.layouts = [(p.shape, p.stride()) for p in params]
        self.clip = clip
        self.ptrs = [t.data_ptr() for t in (*params, *momenta)]
        self.tensors = torch.from_numpy(table.view(np.uint8)).to(device)
        self.chunks = torch.tensor(self.plan.chunks or [(0, 0)],
                                   dtype=torch.int32).to(device)
        self.partials = torch.zeros(max(self.plan.clip_chunks, 1),
                                    dtype=torch.float64, device=device)
        # div, factor and the norm of the last step.
        self.scal = torch.ones(4, dtype=torch.float32, device=device)
        # By tensor, a buffer in its parameter's layout for a gradient that
        # arrives in another, made at the first such step and reused (the
        # copy and the update run in order on the caller's stream).
        self.relaid: Dict[int, torch.Tensor] = {}

    def matches(self, params: Sequence[torch.Tensor],
                momenta: Sequence[torch.Tensor]) -> bool:
        """The tables still describe these tensors."""
        return [t.data_ptr() for t in (*params, *momenta)] == self.ptrs

    def grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``grads`` as float32 on the device, each laid out as its
        parameter (copied where it is not)."""
        if len(grads) != len(self.params):
            raise ValueError(f"sgd_chain: {len(grads)} gradients for "
                             f"{len(self.params)} tensors")
        out = []
        for i, (g, (shape, stride)) in enumerate(zip(grads, self.layouts)):
            if (g.dtype != torch.float32 or g.stride() != stride
                    or g.shape != shape or g.device != self.device):
                if g.device != self.device or g.shape != shape:
                    raise ValueError(
                        f"sgd_chain: gradient {i} is {tuple(g.shape)} on "
                        f"{g.device}, its parameter {tuple(shape)} on "
                        f"{self.device}")
                g = g.float()
                if not _same_layout(g, self.params[i]):
                    buf = self.relaid.get(i)
                    if buf is None:
                        buf = self.relaid[i] = torch.empty_strided(
                            shape, stride, dtype=torch.float32,
                            device=self.device)
                    g = buf.copy_(g)
            out.append(g)
        return out


_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float


def sgd_chain(tables: SgdTables, grads: Sequence[torch.Tensor], *,
              momentum: Tuple[float, float], lr: Tuple[float, float]) -> None:
    """One step of the chain over ``tables``' tensors, in place, with the
    gradients ``grads`` (one a tensor, in the tables' order); group ``k``
    takes ``momentum[k]`` and ``lr[k]``.  Runs under ``no_grad``: raises
    if grad mode is on and a parameter requires grad."""
    _build.refuse_grad("sgd_chain", tables.params,
                       "run the optimizer under torch.no_grad()")
    grads = tables.grads(grads)
    ptrs = (_VOID * len(grads))(*[g.data_ptr() for g in grads])
    pl = tables.plan
    stream = _build.stream_ptr(tables.device)
    t_ptr, c_ptr = tables.tensors.data_ptr(), tables.chunks.data_ptr()
    s_ptr = tables.scal.data_ptr()
    with torch.cuda.device(tables.device):
        if pl.clipped:
            norm = _build.function("scda_sgd_norm", [
                _VOID, _INT, _VOID, _VOID, _INT, _VOID, _VOID])
            _build.check(norm(ptrs, pl.clipped, t_ptr, c_ptr, pl.clip_chunks,
                              tables.partials.data_ptr(), stream),
                         "scda_sgd_norm")
            finish = _build.function("scda_sgd_norm_finish", [
                _VOID, _INT, _FLOAT, _VOID, _VOID])
            _build.check(finish(tables.partials.data_ptr(), pl.clip_chunks,
                                float(tables.clip), s_ptr, stream),
                         "scda_sgd_norm_finish")
        update = _build.function("scda_sgd_update", [
            _VOID, _INT, _VOID, _VOID, _INT, _VOID, _FLOAT, _FLOAT, _FLOAT,
            _FLOAT, _VOID])
        _build.check(update(ptrs, len(grads), t_ptr, c_ptr, len(pl.chunks),
                            s_ptr, float(momentum[0]), float(momentum[1]),
                            -float(lr[0]), -float(lr[1]), stream),
                     "scda_sgd_update")
    sgd_chain.launches += 1


# Calls made (each three launches, one without a clip), as the other
# wrappers count theirs.
sgd_chain.launches = 0


@torch.no_grad()
def sgd_chain_plain(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    momenta: Sequence[torch.Tensor], rules: Sequence[SgdRule],
                    *, clip: Optional[float], momentum: Tuple[float, float],
                    lr: Tuple[float, float]) -> None:
    """Plain PyTorch twin of :func:`sgd_chain`, on any device: the chain
    eagerly, in optax's order, updating ``params`` and ``momenta`` in
    place."""
    g = [t.float() for t in grads]
    clipped = [i for i, r in enumerate(rules) if r.clip]
    if clipped:
        gl = [g[i] for i in clipped]
        # optax's global_norm: sqrt of the summed squares.  Not
        # torch.linalg.vector_norm nor _foreach_norm: on the CPU they
        # sum fc6's 10^8 squares serially in f32, about 1% low; ``sum``
        # reduces pairwise.
        norm = torch.sqrt(torch.stack([t.square().sum() for t in gl]).sum())
        keep = norm < clip
        one = torch.ones_like(norm)
        scaled = torch._foreach_mul(
            torch._foreach_div(gl, torch.where(keep, one, norm)),
            torch.where(keep, one, torch.full_like(norm, clip)))
        for i, t in zip(clipped, scaled):
            g[i] = t
    for wd in sorted({r.decay for r in rules if r.decay}):
        idx = [i for i, r in enumerate(rules) if r.decay == wd]
        decayed = torch._foreach_add(
            [g[i] for i in idx], torch._foreach_mul([params[i] for i in idx], wd))
        for i, t in zip(idx, decayed):
            g[i] = t
    for i, r in enumerate(rules):
        if r.scale != 1.0:
            g[i] = r.scale * g[i]
    # optax trace: decay * trace in the trace's dtype, then + g in f32.
    for p, t, m, r in zip(params, g, momenta, rules):
        trace = t + momentum[r.group] * m
        m.copy_(trace)
        p.add_(trace * -lr[r.group])
