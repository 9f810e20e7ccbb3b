"""A configuration's display modes, channel by channel.

`height`, `refreshrate`, `raster.lines` and `raster.active` may each be one
value for every channel or a list with one entry per channel (`active` a
[width, height] pair, or a list of such pairs); `raster.total_width` is a
list with one entry per channel. A scalar means what it always meant.
Imports nothing: the generator, the reference's geometry and the harness
all read a channel's mode from here."""

from __future__ import annotations


def _at(cfg: dict, key: str, value, c: int, pair: bool = False):
    if not isinstance(value, list) or (pair and not isinstance(value[0], list)):
        return value
    if len(value) != cfg["channels"]:
        raise ValueError(f"{key} has {len(value)} entries for {cfg['channels']} channels")
    return value[c]


def channel_mode(cfg: dict, c: int) -> dict:
    """Channel c's receiver mode (`height`, `refreshrate`) and its emitter's
    raster (`lines`, `total_width`, `active` as (width, height))."""
    if not 0 <= c < cfg["channels"]:
        raise IndexError(f"channel {c} of {cfg['channels']}")
    r = cfg["raster"]
    return dict(height=_at(cfg, "height", cfg["height"], c),
                refreshrate=_at(cfg, "refreshrate", cfg["refreshrate"], c),
                lines=_at(cfg, "raster.lines", r["lines"], c),
                total_width=r["total_width"][c],
                active=tuple(_at(cfg, "raster.active", r["active"], c, pair=True)))


def receiver_modes(cfg: dict) -> list:
    """(height, refreshrate) of every channel's receiver, in channel order."""
    return [(m["height"], m["refreshrate"])
            for m in (channel_mode(cfg, c) for c in range(cfg["channels"]))]
