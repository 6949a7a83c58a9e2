"""Host-side image preprocessing on numpy ``uint8`` (H, W, 3) arrays.

Counterpart of ``codeps_tpu/data/preprocessing.py``, which works on PIL
images; this module imports no PIL, so the streamed path runs where Pillow
is absent. The color jitter reproduces Pillow's integer arithmetic:

  - ``ImageEnhance`` is ``Image.blend(degenerate, image, factor)`` in
    single precision, truncated to ``uint8`` (clipped when the factor lies
    outside [0, 1]); the degenerate image is black (brightness), the mean
    of the ``L`` image rounded (contrast) or the ``L`` image (saturation);
  - ``L`` is ITU-R 601-2 luma in 16-bit fixed point;
  - hue goes through Pillow's RGB <-> HSV conversions.

The random draws keep the JAX package's order: one ``uniform`` per active
factor (brightness, contrast, saturation, hue), ``shuffle`` of the order,
then ``random()`` for the flip; they come from the ``random.Random`` the
caller passes.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import random
from typing import Any, Callable, Dict

import numpy as np

_GRAY_WEIGHTS = np.asarray([0.2125, 0.7154, 0.0721])  # skimage rgb2gray


@functools.lru_cache(maxsize=1)
def _pool() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        thread_name_prefix="preprocessing")


class ImageWork:
    """Pixel work on the frames of sample dicts, run later in threads.

    ``add(images, offset, step)`` chains ``step`` onto the frame
    ``images[offset]``; ``run()`` runs every frame's chain, the frames in
    parallel threads (numpy lets go of the interpreter lock in its loops),
    and writes the results back. Steps draw nothing at random, so a caller
    that makes its draws while adding steps gets the same results as one
    that works frame by frame."""

    def __init__(self):
        self._chains: Dict[Any, tuple] = {}

    def add(self, images: Dict[Any, np.ndarray], offset,
            step: Callable[[np.ndarray], np.ndarray]) -> None:
        key = (id(images), offset)
        if key not in self._chains:
            self._chains[key] = (images, offset, [])
        self._chains[key][2].append(step)

    def run(self) -> None:
        chains = list(self._chains.values())
        self._chains = {}

        def apply(chain):
            images, offset, steps = chain
            img = images[offset]
            for step in steps:
                img = step(img)
            return img

        results = ([apply(c) for c in chains] if len(chains) < 2
                   else list(_pool().map(apply, chains)))
        for (images, offset, _), img in zip(chains, results):
            images[offset] = img


# ------------------------------------------------------------- color jitter

def to_luma(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    rgb = img.astype(np.int32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _blend_table(factor: float) -> np.ndarray:
    """(256, 256) uint8 ``Image.blend`` of every (in1, in2) pair:
    in1 + alpha * (in2 - in1) in float32 with a float32 alpha, truncated;
    clipped to [0, 255] when alpha extrapolates."""
    alpha = np.float32(factor)
    in1 = np.arange(256, dtype=np.float32)[:, None]
    in2 = np.arange(256, dtype=np.float32)[None, :]
    out = in1 + alpha * (in2 - in1)
    if not 0.0 <= alpha <= 1.0:
        out = np.clip(out, 0.0, 255.0)
    return out.astype(np.uint8)


def blend(degenerate: np.ndarray, img: np.ndarray,
          factor: float) -> np.ndarray:
    """``Image.blend(degenerate, img, factor)`` of uint8 images, looked up
    in the table of every pair of values (the same float32 arithmetic)."""
    table = _blend_table(factor)
    degenerate = np.asarray(degenerate)
    if degenerate.ndim == 0:
        return np.take(table[int(degenerate)], img)
    index = (degenerate.astype(np.uint16) << 8) | img
    return np.take(table.reshape(-1), index)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return blend(np.zeros((), np.uint8), img, factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # ImageStat's mean of the L image in float64, rounded half up
    mean = int(to_luma(img).mean(dtype=np.float64) + 0.5)
    return blend(np.asarray(mean, np.uint8), img, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    return blend(to_luma(img)[..., None], img, factor)


def _rgb_to_hs(r, g, b):
    """Pillow's ``rgb2hsv`` (Convert.c) hue and saturation of int32 channel
    arrays: float hue and saturation scaled to 0-255 and truncated (zero
    for greys)."""
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(np.float32)
    s = cr / np.where(grey, 1, maxc).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / cr
    gc = (maxc - g).astype(np.float32) / cr
    bc = (maxc - b).astype(np.float32) / cr
    # C: "bc - gc" in float; "2.0 + rc - bc" and "4.0 + gc - rc" in double
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc,
                          2.0 + rc.astype(np.float64) - bc,
                          4.0 + gc.astype(np.float64) - rc))
    h = h.astype(np.float32).astype(np.float64)
    h = np.fmod(h / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int32), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int32), 0, 255)
    return np.where(grey, 0, uh), np.where(grey, 0, us)


@functools.lru_cache(maxsize=1)
def _hs_table() -> np.ndarray:
    """(2^24,) uint16 hue << 8 | saturation of every RGB triple
    (r << 16 | g << 8 | b): 32 MiB, built once."""
    table = np.empty(1 << 24, np.uint16)
    rgb = np.arange(1 << 20, dtype=np.int32)
    for hi in range(16):
        code = (hi << 20) | rgb
        uh, us = _rgb_to_hs(code >> 16, (code >> 8) & 255, code & 255)
        table[hi << 20:(hi + 1) << 20] = (uh << 8) | us
    return table


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> HSV of a uint8 (..., 3) image; value = max channel.
    Hue and saturation come from a table of every RGB triple."""
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    hs = _hs_table()[(r << 16) | (g << 8) | b]
    return np.stack([(hs >> 8).astype(np.uint8), (hs & 255).astype(np.uint8),
                     np.maximum(np.maximum(img[..., 0], img[..., 1]),
                                img[..., 2])], axis=-1)


@functools.lru_cache(maxsize=1)
def _hsv_tables():
    """Pillow's ``hsv2rgb`` (Convert.c) terms over the 256 hues and
    saturations, in its float/double mix: the sector of each hue, the
    factors (1 - fs), (1 - fs * f) with fs * f in float, and
    (1 - fs * (1 - f)) in double, with f = h * 6 / 255 - i in float and
    fs = s / 255 in float."""
    h6 = (np.arange(256, dtype=np.float32).astype(np.float64) * 6.0) / 255.0
    i = np.floor(h6).astype(np.int32)
    f = (h6 - i).astype(np.float32)                          # (h,)
    fs = (np.arange(256, dtype=np.float32).astype(np.float64)
          / 255.0).astype(np.float32)                        # (s,)
    one_fs = 1.0 - fs.astype(np.float64)
    one_fsf = 1.0 - (fs[:, None] * f[None, :]).astype(np.float64)
    one_fs1f = 1.0 - fs.astype(np.float64)[:, None] \
        * (1.0 - f.astype(np.float64))[None, :]
    return (i % 6).astype(np.uint8), one_fs, one_fsf.reshape(-1), \
        one_fs1f.reshape(-1)


# channel sources of each sector among (v, p, q, t)
_SECTORS = np.asarray([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0],
                       [3, 1, 0], [0, 1, 2]], np.intp)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Pillow's HSV -> RGB of a uint8 (..., 3) image, computed."""
    sector, one_fs, one_fsf, one_fs1f = _hsv_tables()
    h = hsv[..., 0].astype(np.intp)
    s = hsv[..., 1].astype(np.intp)
    v = hsv[..., 2]
    vd = v.astype(np.float64)
    sh = (s << 8) | h

    def c_round(x):  # C round() of x >= 0: half away from zero
        r = np.floor(x)
        return (r + (x - r >= 0.5)).astype(np.uint8)

    # s == 0 gives p = q = t = v in every sector
    terms = np.stack([v, c_round(vd * one_fs[s]), c_round(vd * one_fsf[sh]),
                      c_round(vd * one_fs1f[sh])], axis=-1)
    return np.take_along_axis(terms, _SECTORS[sector[h]], axis=-1)


@functools.lru_cache(maxsize=1)
def _rgb_table() -> np.ndarray:
    """(2^24, 3) uint8 RGB of every HSV triple (h << 16 | s << 8 | v):
    48 MiB, built once."""
    table = np.empty((1 << 24, 3), np.uint8)
    code = np.arange(1 << 20, dtype=np.int32)
    for hi in range(16):
        hsv = (((hi << 20) | code)[:, None] >> np.asarray([16, 8, 0])) & 255
        table[hi << 20:(hi + 1) << 20] = _hsv_to_rgb(hsv.astype(np.uint8))
    return table


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Pillow's HSV -> RGB of a uint8 (..., 3) image, from a table of
    every HSV triple."""
    h, s, v = (hsv[..., i].astype(np.int32) for i in range(3))
    return np.take(_rgb_table(), (h << 16) | (s << 8) | v, axis=0)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Shift hue by ``factor`` in [-0.5, 0.5] (torchvision's PIL path)."""
    if not -0.5 <= factor <= 0.5:
        raise ValueError(f"hue factor {factor} not in [-0.5, 0.5]")
    hsv = rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                   + int(factor * 255)).astype(np.uint8)
    return hsv_to_rgb(hsv)


def get_random_color_jitter(rng: random.Random, brightness, contrast,
                            saturation, hue):
    """Random factors and a random order of application
    (``preprocessing.py:49-72`` of the JAX package)."""
    transforms = []
    if brightness is not None:
        factor = rng.uniform(1 - brightness, 1 + brightness)
        transforms.append(lambda img, f=factor: adjust_brightness(img, f))
    if contrast is not None:
        factor = rng.uniform(1 - contrast, 1 + contrast)
        transforms.append(lambda img, f=factor: adjust_contrast(img, f))
    if saturation is not None:
        factor = rng.uniform(1 - saturation, 1 + saturation)
        transforms.append(lambda img, f=factor: adjust_saturation(img, f))
    if hue is not None:
        factor = rng.uniform(-hue, hue)
        transforms.append(lambda img, f=factor: adjust_hue(img, f))
    rng.shuffle(transforms)

    def apply(img: np.ndarray) -> np.ndarray:
        for transform in transforms:
            img = transform(img)
        return img

    return apply


# --------------------------------------------------------------- pipeline

def prepare_for_network(output: Dict[str, Any], normalization_cfg,
                        work: ImageWork | None = None) -> None:
    """uint8 frames -> float32 (H, W, 3) in [0, 1], normalized when the
    config says so; with ``uint8_transfer`` (and normalization active) the
    frames stay uint8 and the steps normalize them on the device. With
    ``work`` the frames are converted when it runs."""
    mean = np.asarray(normalization_cfg.rgb_mean, np.float32)
    std = np.asarray(normalization_cfg.rgb_std, np.float32)
    keep_uint8 = (normalization_cfg.get("uint8_transfer", False)
                  and normalization_cfg.active)

    def prepare(img):
        if keep_uint8:
            return np.asarray(img, np.uint8)
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - mean) / std if normalization_cfg.active else arr

    own = work is None
    work = ImageWork() if own else work
    for offset in output["rgb"]:
        work.add(output["rgb"], offset, prepare)
    if own:
        work.run()


def augment_data(output: Dict[str, Any], augmentation_cfg,
                 rng: random.Random, work: ImageWork | None = None) -> None:
    """Shared flip and color jitter over a sample dict, in place.

    The flip mirrors the camera's cx, flips every spatial array along x
    and negates the offset map's x channel (``offset[..., 1]``). The
    random draws happen here; with ``work`` the frames are flipped and
    jittered when it runs."""
    if not augmentation_cfg.active:
        return
    jitter = get_random_color_jitter(
        rng,
        augmentation_cfg.brightness_jitter,
        augmentation_cfg.contrast_jitter,
        augmentation_cfg.saturation_jitter,
        augmentation_cfg.hue_jitter)
    do_flip = augmentation_cfg.horizontal_flipping and rng.random() > 0.5

    def flip_and_jitter(img):
        return np.ascontiguousarray(jitter(img[:, ::-1] if do_flip else img))

    own = work is None
    work = ImageWork() if own else work
    for key, value in output.items():
        if key == "rgb":
            for offset in value:
                work.add(value, offset, flip_and_jitter)
        elif key == "camera_model":
            if do_flip:
                img_width = output["rgb"][0].shape[1]
                value[2] = img_width - value[2] - 1  # mirror cx
        elif do_flip:
            flipped = np.flip(value, axis=1).copy()
            if key == "offset":
                flipped[..., 1] *= -1
            output[key] = flipped
    if own:
        work.run()


# ---------------------------------------------------- histogram matching

def _match_cumulative_cdf(source: np.ndarray,
                          template: np.ndarray) -> np.ndarray:
    """skimage ``match_histograms``' single-channel core; a uint8 result
    is truncated, as skimage's assignment into a uint8 array does."""
    if source.dtype == template.dtype == np.uint8:
        # np.unique's values and counts of uint8 data, from a histogram
        src_counts = np.bincount(source.ravel(), minlength=256)
        tmpl_counts = np.bincount(template.ravel(), minlength=256)
        src_values = np.flatnonzero(src_counts)
        tmpl_values = np.flatnonzero(tmpl_counts).astype(np.uint8)
        src_quantiles = np.cumsum(src_counts[src_values]) / source.size
        tmpl_quantiles = np.cumsum(tmpl_counts[tmpl_values]) / template.size
        interp = np.interp(src_quantiles, tmpl_quantiles, tmpl_values)
        lut = np.zeros(256, np.uint8)
        lut[src_values] = interp.clip(0, 255).astype(np.uint8)
        return lut[source]
    src_values, src_unique_indices, src_counts = np.unique(
        source.ravel(), return_inverse=True, return_counts=True)
    tmpl_values, tmpl_counts = np.unique(template.ravel(),
                                         return_counts=True)
    src_quantiles = np.cumsum(src_counts) / source.size
    tmpl_quantiles = np.cumsum(tmpl_counts) / template.size
    interp = np.interp(src_quantiles, tmpl_quantiles, tmpl_values)
    matched = interp[src_unique_indices].reshape(source.shape)
    if source.dtype == np.uint8:
        matched = matched.clip(0, 255).astype(np.uint8)
    return matched


def match_histograms(image: np.ndarray,
                     reference: np.ndarray) -> np.ndarray:
    """Channel-wise histogram matching (channel axis last)."""
    matched = np.empty_like(image)
    for c in range(image.shape[-1]):
        matched[..., c] = _match_cumulative_cdf(image[..., c],
                                                reference[..., c])
    return matched


def transfer_histogram_style(img: np.ndarray, reference_img: np.ndarray,
                             mode: str | None) -> np.ndarray:
    """Histogram style transfer of uint8 RGB arrays (``rgb`` mode, the one
    the replay buffer uses, or none)."""
    if mode == "rgb":
        return match_histograms(np.asarray(img), np.asarray(reference_img))
    if mode is None:
        return img
    raise ValueError(f"Unsupported histogram transfer mode: {mode}")


# ------------------------------------------------------------ low contrast

def is_low_contrast(image, fraction_threshold: float = 0.05,
                    lower_percentile: float = 1,
                    upper_percentile: float = 99) -> bool:
    """skimage ``exposure.is_low_contrast`` for RGB or grey uint8/float
    images: an RGB image is converted to float grey, whose dtype range is
    2, so its percentile spread is halved before the comparison."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[2] in (3, 4):
        image = image[..., :3]
        if image.dtype == np.uint8:
            image = image.astype(np.float64) / 255.0
        image = image @ _GRAY_WEIGHTS
        dtype_range = 2.0
    elif image.dtype == np.uint8:
        image = image.astype(np.float64)
        dtype_range = 255.0
    else:
        dtype_range = 2.0
    limits = np.percentile(image, [lower_percentile, upper_percentile])
    return bool((limits[1] - limits[0]) / dtype_range < fraction_threshold)
