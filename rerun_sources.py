"""Which source of run-to-run variation moves the card's rerun gap.

Run it on a checkout of the tree before ``scda_tpu_torch/utils/numerics.py``
and the K2 backward without atomics (the parent of that change), on one
card, with this file copied beside that tree's ``chip_smoke.py``:

    git archive <parent> | tar -x -C .chipwork/parent
    cp rerun_sources.py .chipwork/parent/
    (cd .chipwork/parent && python3 rerun_sources.py)

It runs the oracle's ``card_rerun`` (20 steps twice, the second
replaying the first's proposals, and a third drawing its own) and a
VGG16 bs 8 train run of 5 steps twice, each under variants that remove
one source at a time: the K2 backward swapped for its plain twin,
``cudnn.deterministic``, ``torch.use_deterministic_algorithms`` (warn
only), and their sums; then that tree's ``chip_smoke.py`` paths under
deterministic algorithms with ``warn_only``, listing every op that has
no deterministic CUDA implementation.  One JSON line per run; the
paths' own output goes to ``rerun_sources_smoke.log`` in the working
directory.  On a tree
whose entry points call ``set_card_numerics`` every variant repeats
bit for bit, so the script has nothing left to tell apart there.
"""
import contextlib
import json
import os
import sys
import tempfile
import time
import traceback
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SEEN = {}


def hook(message, category, filename, lineno, file=None, line=None):
    key = str(message).split("\n")[0][:300]
    SEEN[key] = SEEN.get(key, 0) + 1


warnings.showwarning = hook
warnings.simplefilter("always")


def emit(obj):
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def variant(name, port):
    k2 = "k2" in name
    cud = "cudnn" in name
    det = "algos" in name
    torch.backends.cudnn.deterministic = cud
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(det, warn_only=True)
    with contextlib.ExitStack() as st:
        if k2:
            plain = port.rk.roi_align_contract_bwd_plain
            st.enter_context(cs.Recorder(
                port.rk, "roi_align_contract_bwd",
                lambda wy, wx, g, h, w, dtype=torch.float32: plain(
                    wy, wx, g, dtype)))
        yield
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)


VARIANTS = ("base", "k2", "cudnn", "algos", "k2+cudnn", "k2+cudnn+algos")


def rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a - b)


def oracle(port, device, tmp):
    cfg, ds, run = cs.oracle_runs(port, tmp)
    n = 20
    out = {}
    for name in VARIANTS:
        with variant(name, port):
            t0 = time.perf_counter()
            m1, l1, p1, _ = run(device, n)
            steps = iter(p1.results)
            rep = cs.Recorder(port.detector, "propose", lambda *a, **k: type(
                p1.results[0])(*(t.to(device) for t in next(steps))))
            m2, l2, _, _ = run(device, n, [rep])
            m3, l3, _, _ = run(device, n)
            eq_rep = all(torch.equal(a, b) for a, b in zip(
                m1.parameters(), m2.parameters()))
            eq_free = all(torch.equal(a, b) for a, b in zip(
                m1.parameters(), m3.parameters()))
            out[name] = {
                "replay_rel_gap": [rel(a, b) for a, b in zip(l2, l1)],
                "free_rel_gap": [rel(a, b) for a, b in zip(l3, l1)],
                "replay_losses_equal": l1 == l2, "free_losses_equal": l1 == l3,
                "replay_params_equal": eq_rep, "free_params_equal": eq_free,
                "seconds": time.perf_counter() - t0}
            emit({"diag": "oracle_rerun", "variant": name, **out[name]})
            del m1, m2, m3
    return out


def vgg_bs8(port, device, frames):
    _, cfg = port.train_cfgs("vgg16", 8)
    model = port.train_model(cfg, "cpu")
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    batches = port.train_batches(frames, 8, device)

    def go():
        m = port.train_model(cfg, device, state0)
        st = port.create_train_state(cfg, m, steps_per_epoch=1000)
        step = port.make_train_step(m, cfg)
        losses = []
        for i in range(5):
            st, met = step(st, *batches[i % len(batches)])
            losses.append(float(met["loss"]))
        return m, losses

    for name in ("base", "k2", "cudnn", "k2+cudnn", "k2+cudnn+algos"):
        with variant(name, port):
            t0 = time.perf_counter()
            m1, l1 = go()
            m2, l2 = go()
            eq = all(torch.equal(a, b) for a, b in zip(m1.parameters(),
                                                          m2.parameters()))
            diff = max(float((a - b).abs().max()) for a, b in zip(
                m1.parameters(), m2.parameters()))
            emit({"diag": "vgg16_bs8_rerun", "variant": name,
                  "rel_gap": [rel(a, b) for a, b in zip(l2, l1)],
                  "losses_equal": l1 == l2, "params_equal": eq,
                  "params_max_abs_diff": diff,
                  "seconds": time.perf_counter() - t0})
            del m1, m2
            torch.cuda.empty_cache()


def main():
    device = torch.device("cuda", 0)
    emit({"diag": "device", "smi": cs.nvidia_smi_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    from scda_tpu_torch.ops.kernels import _build
    _build.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    port = cs.Port(torch)
    frames = cs.make_frames(port.serving_cfgs("vgg16")[0], cs.N_FRAMES, seed=1)
    tmp = tempfile.mkdtemp()
    for fn, args in ((oracle, (port, device, os.path.join(tmp, "o"))),
                     (vgg_bs8, (port, device, frames))):
        try:
            fn(*args)
        except Exception:
            traceback.print_exc()
    emit({"diag": "warnings_in_experiments", "seen": SEEN})
    SEEN.clear()
    # The warn-only scan over chip_smoke's paths.
    torch.use_deterministic_algorithms(True, warn_only=True)
    only = sys.argv[1] if len(sys.argv) > 1 else (
        "vgg16,res101_ms,vgg16_train,res101_ms_train,vgg16_scda,"
        "vgg16_surface")
    sys.argv = ["chip_smoke.py", "--only", only]
    t0 = time.perf_counter()
    try:
        with open("rerun_sources_smoke.log", "w") as f, \
                contextlib.redirect_stdout(f):
            rc = cs.main()
    except Exception:
        traceback.print_exc()
        rc = "raised"
    emit({"diag": "scan", "rc": rc, "seconds": time.perf_counter() - t0,
          "nondeterministic_warnings": SEEN})


if __name__ == "__main__":
    main()
