"""Frame snapshots — the GUI's PNG snapshot equivalent (Main.java:1095-1116).

Frames are float grayscale in ~[0,1] after autogain. Formats: .npy (exact),
.pgm (dependency-free 8-bit), .png when PIL is available. Special debug
pixel values map to saturated channels like the JNI converter
(TSDRLibraryNDK.c:222-279)."""

from __future__ import annotations

import numpy as np

from .config import (
    PIXEL_SPECIAL_VALUE_B,
    PIXEL_SPECIAL_VALUE_G,
    PIXEL_SPECIAL_VALUE_R,
)


def frame_to_u8(frame: np.ndarray, invert: bool = False) -> np.ndarray:
    """float frame -> uint8 grayscale with clamping (TSDRLibraryNDK.c:222-279)."""
    f = np.asarray(frame, np.float32)
    g = np.clip(f, 0.0, 1.0)
    if invert:
        g = 1.0 - g
    return (g * 255.0 + 0.5).astype(np.uint8)


def frame_to_rgb(frame: np.ndarray, invert: bool = False) -> np.ndarray:
    """Like the JNI converter: grayscale plus the debug marker colours."""
    g = frame_to_u8(frame, invert)
    rgb = np.stack([g, g, g], axis=-1)
    f = np.asarray(frame, np.float32)
    for val, ch in ((PIXEL_SPECIAL_VALUE_R, 0), (PIXEL_SPECIAL_VALUE_G, 1), (PIXEL_SPECIAL_VALUE_B, 2)):
        m = f == val
        rgb[m] = 0
        rgb[m, ch] = 255
    return rgb


def save_frame(frame: np.ndarray, path: str, invert: bool = False) -> None:
    if path.endswith(".npy"):
        np.save(path, np.asarray(frame))
        return
    if path.endswith(".pgm"):
        u8 = frame_to_u8(frame, invert)
        h, w = u8.shape
        with open(path, "wb") as f:
            f.write(f"P5\n{w} {h}\n255\n".encode())
            f.write(u8.tobytes())
        return
    if path.endswith(".png"):
        try:
            from PIL import Image  # type: ignore
        except ImportError as e:
            raise RuntimeError("PNG output requires PIL; use .pgm or .npy") from e
        Image.fromarray(frame_to_rgb(frame, invert)).save(path)
        return
    raise ValueError(f"unsupported snapshot format: {path}")
