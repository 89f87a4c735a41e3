"""The general generator of the benchmark's inputs: structured scenes
through the host prep, from a seed.

Frozen copies, at commit 8b959ad8dec4, of ``_draw_scene`` from
``scda_tpu_torch/data/synthetic.py`` (coloured boxes with dark borders on
a textured background, optional fog) and of the host-prep arithmetic of
``scda_tpu_torch/data/pipeline.py`` (``compute_scale``,
``oriented_canvas``, the NumPy path of ``prepare_image``:
``_resize_bilinear_np``, BGR mean subtraction, pasting into the fixed
canvas), and of ``bench_torch.py``'s ``structured_batches`` gt scaling.
A traffic mix (a ``.json`` file beside this one) gives the sizes; the
seed gives the draws.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_FALLBACK = [(220, 40, 30), (40, 200, 60), (40, 70, 220),
             (230, 210, 40), (200, 80, 220), (50, 210, 210)]


def draw_scene(rng: np.random.RandomState, height: int, width: int,
               max_objects: int, num_classes: int, fog: float = 0.0):
    """Returns (rgb uint8 image, boxes (G, 4) f32, labels (G,) i32)."""
    img = rng.randint(60, 120, (height, width, 3)).astype(np.float32)
    yy = np.linspace(0, 4 * np.pi, height)[:, None]
    xx = np.linspace(0, 4 * np.pi, width)[None, :]
    img += 25 * np.sin(yy + rng.rand() * 6)[..., None]
    img += 25 * np.cos(xx + rng.rand() * 6)[..., None]
    n = rng.randint(1, max_objects + 1)
    boxes, labels = [], []
    for _ in range(n):
        w = rng.randint(max(12, width // 16), width // 3)
        h = rng.randint(max(12, height // 16), height // 3)
        x1 = rng.randint(0, width - w)
        y1 = rng.randint(0, height - h)
        cls = rng.randint(num_classes)
        color = np.asarray(_FALLBACK[cls % len(_FALLBACK)], np.float32)
        jitter = rng.randn(3) * 10
        img[y1:y1 + h, x1:x1 + w] = color + jitter
        img[y1:y1 + 2, x1:x1 + w] = 10
        img[y1 + h - 2:y1 + h, x1:x1 + w] = 10
        boxes.append([x1, y1, x1 + w - 1, y1 + h - 1])
        labels.append(cls + 1)
    if fog > 0:
        img = (1 - fog) * img + fog * 200.0
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


def compute_scale(height: int, width: int, target: int, max_size: int) -> float:
    short, long_ = min(height, width), max(height, width)
    scale = float(target) / short
    if round(scale * long_) > max_size:
        scale = float(max_size) / long_
    return scale


def oriented_canvas(data, height: int, width: int) -> Tuple[int, int]:
    ch, cw = data.image_size
    if data.orientation_aware and (height > width) != (ch > cw) \
            and height != width and ch != cw:
        return cw, ch
    return ch, cw


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    fy = np.clip((np.arange(out_h) + 0.5) * (sh / out_h) - 0.5, 0, sh - 1)
    fx = np.clip((np.arange(out_w) + 0.5) * (sw / out_w) - 0.5, 0, sw - 1)
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    ly = (fy - y0).astype(np.float32)[:, None, None]
    lx = (fx - x0).astype(np.float32)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - lx) + img[y0][:, x1] * lx
    bot = img[y1][:, x0] * (1 - lx) + img[y1][:, x1] * lx
    return top * (1 - ly) + bot * ly


def prepare_image(img_bgr: np.ndarray, data):
    """Scale, mean-subtract and paste into the canvas: (canvas (H, W, 3)
    f32, scale, (valid_h, valid_w))."""
    h, w = img_bgr.shape[:2]
    canvas_h, canvas_w = oriented_canvas(data, h, w)
    scale = compute_scale(h, w, data.scale, data.max_size)
    scale = min(scale, canvas_h / h, canvas_w / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    img = img_bgr.astype(np.float32)
    if (new_h, new_w) != (h, w):
        img = resize_bilinear(img, new_h, new_w)
    img = img - np.asarray(data.pixel_means, np.float32)
    canvas = np.zeros((canvas_h, canvas_w, 3), np.float32)
    canvas[:new_h, :new_w] = img
    return canvas, scale, (new_h, new_w)


def _scene(data, seed, scene_hw, max_objects, num_classes, fog, max_gt):
    rng = np.random.RandomState(seed)
    rgb, boxes, labels = draw_scene(rng, scene_hw[0], scene_hw[1],
                                    max_objects, num_classes, fog)
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    canvas, scale, (vh, vw) = prepare_image(bgr, data)
    gt = np.zeros((max_gt, 5), np.float32)
    n = min(len(boxes), max_gt)
    gt[:n, :4] = boxes[:n] * scale
    gt[:n, 4] = labels[:n]
    return canvas, [vh, vw, scale], gt, n


def batches(data, seed: np.random.SeedSequence, n_batches: int,
            batch_size: int, scene_hw, max_objects: int, num_classes: int,
            fog: float = 0.0, max_gt: int = 50, threads: int = 4) -> List[tuple]:
    """``n_batches`` batches of distinct scenes, each scene from a stream
    of its own spawned from ``seed`` (so that a few threads can draw them
    side by side and every scene is the same whatever the thread count):
    (image (B, H, W, 3) f32, im_info (B, 3), gt (B, G, 5), num (B,))
    NumPy arrays."""
    from concurrent.futures import ThreadPoolExecutor

    seeds = [int(s.generate_state(1)[0])
             for s in seed.spawn(n_batches * batch_size)]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        scenes = list(pool.map(
            lambda sd: _scene(data, sd, scene_hw, max_objects, num_classes,
                              fog, max_gt), seeds))
    out = []
    for i in range(n_batches):
        part = scenes[i * batch_size:(i + 1) * batch_size]
        out.append((np.stack([p[0] for p in part]),
                    np.asarray([p[1] for p in part], np.float32),
                    np.stack([p[2] for p in part]),
                    np.asarray([p[3] for p in part], np.int32)))
    return out
