"""VESA video-mode table with *total* (including blanking) geometry.

The mode list and nearest-mode matching mirror
JavaGUI/src/martin/tempest/gui/VideoMode.java:25-190 — these are standard
display timing totals (GTF/DMT), which is why TEMPEST reception must fold at
the total raster, not the visible resolution.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence


class VideoMode(NamedTuple):
    name: str
    width: int  # total pixels per line incl. blanking
    height: int  # total lines incl. blanking
    refreshrate: float


VIDEO_MODES: tuple[VideoMode, ...] = tuple(
    VideoMode(*m)
    for m in [
        ("PAL TV", 576, 625, 25),
        ("640x400 @ 85Hz", 832, 445, 85),
        ("720x400 @ 85Hz", 936, 446, 85),
        ("640x480 @ 60Hz", 800, 525, 60),
        ("640x480 @ 100Hz", 848, 509, 100),
        ("640x480 @ 72Hz", 832, 520, 72),
        ("640x480 @ 75Hz", 840, 500, 75),
        ("640x480 @ 85Hz", 832, 509, 85),
        ("768x576 @ 60 Hz", 976, 597, 60),
        ("768x576 @ 72 Hz", 992, 601, 72),
        ("768x576 @ 75 Hz", 1008, 602, 75),
        ("768x576 @ 85 Hz", 1008, 605, 85),
        ("768x576 @ 100 Hz", 1024, 611, 100),
        ("800x600 @ 56Hz", 1024, 625, 56),
        ("800x600 @ 60Hz", 1056, 628, 60),
        ("800x600 @ 72Hz", 1040, 666, 72),
        ("800x600 @ 75Hz", 1056, 625, 75),
        ("800x600 @ 85Hz", 1048, 631, 85),
        ("800x600 @ 100Hz", 1072, 636, 100),
        ("1024x600 @ 60 Hz", 1312, 622, 60),
        ("1024x768i @ 43Hz", 1264, 817, 43),
        ("1024x768 @ 60Hz", 1344, 806, 60),
        ("1024x768 @ 70Hz", 1328, 806, 70),
        ("1024x768 @ 75Hz", 1312, 800, 75),
        ("1024x768 @ 85Hz", 1376, 808, 85),
        ("1024x768 @ 100Hz", 1392, 814, 100),
        ("1024x768 @ 120Hz", 1408, 823, 120),
        ("1152x864 @ 60Hz", 1520, 895, 60),
        ("1152x864 @ 75Hz", 1600, 900, 75),
        ("1152x864 @ 85Hz", 1552, 907, 85),
        ("1152x864 @ 100Hz", 1568, 915, 100),
        ("1280x768 @ 60 Hz", 1680, 795, 60),
        ("1280x800 @ 60 Hz", 1680, 828, 60),
        ("1280x960 @ 60Hz", 1800, 1000, 60),
        ("1280x960 @ 75Hz", 1728, 1002, 75),
        ("1280x960 @ 85Hz", 1728, 1011, 85),
        ("1280x960 @ 100Hz", 1760, 1017, 100),
        ("1280x1024 @ 60Hz", 1688, 1066, 60),
        ("1280x1024 @ 75Hz", 1688, 1066, 75),
        ("1280x1024 @ 85Hz", 1728, 1072, 85),
        ("1280x1024 @ 100Hz", 1760, 1085, 100),
        ("1280x1024 @ 120Hz", 1776, 1097, 120),
        ("1368x768 @ 60 Hz", 1800, 795, 60),
        ("1400x1050 @ 60Hz", 1880, 1082, 60),
        ("1400x1050 @ 72 Hz", 1896, 1094, 72),
        ("1400x1050 @ 75 Hz", 1896, 1096, 75),
        ("1400x1050 @ 85 Hz", 1912, 1103, 85),
        ("1400x1050 @ 100 Hz", 1928, 1112, 100),
        ("1440x900 @ 60 Hz", 1904, 932, 60),
        ("1440x1050 @ 60 Hz", 1936, 1087, 60),
        ("1600x1000 @ 60Hz", 2144, 1035, 60),
        ("1600x1000 @ 75Hz", 2160, 1044, 75),
        ("1600x1000 @ 85Hz", 2176, 1050, 85),
        ("1600x1000 @ 100Hz", 2192, 1059, 100),
        ("1600x1024 @ 60Hz", 2144, 1060, 60),
        ("1600x1024 @ 75Hz", 2176, 1069, 75),
        ("1600x1024 @ 76Hz", 2096, 1070, 76),
        ("1600x1024 @ 85Hz", 2176, 1075, 85),
        ("1600x1200 @ 60Hz", 2160, 1250, 60),
        ("1600x1200 @ 65Hz", 2160, 1250, 65),
        ("1600x1200 @ 70Hz", 2160, 1250, 70),
        ("1600x1200 @ 75Hz", 2160, 1250, 75),
        ("1600x1200 @ 85Hz", 2160, 1250, 85),
        ("1600x1200 @ 100 Hz", 2208, 1271, 100),
        ("1680x1050 @ 60Hz (reduced blanking)", 1840, 1080, 60),
        ("1680x1050 @ 60Hz (non-interlaced)", 2240, 1089, 60),
        ("1680x1050 @ 60 Hz", 2256, 1087, 60),
        ("1792x1344 @ 60Hz", 2448, 1394, 60),
        ("1792x1344 @ 75Hz", 2456, 1417, 75),
        ("1856x1392 @ 60Hz", 2528, 1439, 60),
        ("1856x1392 @ 75Hz", 2560, 1500, 75),
        ("1920x1080 @ 60Hz", 2576, 1125, 60),
        ("1920x1080 @ 75Hz", 2608, 1126, 75),
        ("1920x1200 @ 60Hz", 2592, 1242, 60),
        ("1920x1200 @ 75Hz", 2624, 1253, 75),
        ("1920x1440 @ 60Hz", 2600, 1500, 60),
        ("1920x1440 @ 75Hz", 2640, 1500, 75),
        ("1920x2400 @ 25Hz", 2048, 2434, 25),
        ("1920x2400 @ 30Hz", 2044, 2434, 30),
        ("2048x1536 @ 60Hz", 2800, 1589, 60),
    ]
)


def find_closest_mode(
    refreshrate: float,
    height: int,
    width: Optional[int] = None,
    modes: Sequence[VideoMode] = VIDEO_MODES,
) -> Optional[VideoMode]:
    """Nearest-mode match (VideoMode.java:147-190): exact (width,)height match
    minimizing |refresh delta|, falling back to nearest height."""
    best = None
    diff = 5000.0
    for m in modes:
        if m.height == height and (width is None or m.width == width):
            d = abs(m.refreshrate - refreshrate)
            if d < diff:
                diff, best = d, m
    if best is None and width is None:
        idiff = 5000
        for m in modes:
            d = abs(m.height - height)
            if d < idiff:
                idiff, best = d, m
    return best
