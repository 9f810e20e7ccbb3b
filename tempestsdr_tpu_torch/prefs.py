"""Persistent user preferences — the headless counterpart of the GUI's
java.util.prefs store.

The reference GUI persists every user-tunable setting across runs: frequency,
gain, motion blur, height, refresh rate, the peak-selection area, the last
source and its parameter string (Main.java:90-104 PREF_* loads, saves at the
matching control handlers), and each PARAM toggle's state
(ParametersToggleButton.java:33-55 reads/writes its Preferences key on
toggle). Here the store is one JSON file (default
``~/.config/tempestsdr_tpu/prefs.json``, overridable via ``TSDR_PREFS_PATH``)
written atomically; the CLI exposes it as ``--save-prefs`` (persist this
run's settings on exit) and ``--use-prefs`` (apply saved values as defaults
for any option not given on the command line).
"""

from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["Preferences", "default_prefs_path"]


def default_prefs_path() -> str:
    env = os.environ.get("TSDR_PREFS_PATH")
    if env:
        return env
    base = os.environ.get("XDG_CONFIG_HOME") or os.path.join(
        os.path.expanduser("~"), ".config")
    return os.path.join(base, "tempestsdr_tpu", "prefs.json")


class Preferences:
    """A tiny typed key-value store with atomic persistence.

    Mirrors the subset of java.util.prefs the reference uses: get-with-
    default and put (Main.java:90-104); unknown/corrupt stores behave as
    empty (the GUI's behaviour on a fresh machine).
    """

    def __init__(self, path: str | None = None):
        self.path = path or default_prefs_path()
        self._data: dict[str, Any] = {}
        try:
            with open(self.path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                self._data = loaded
        except (OSError, ValueError):
            pass  # missing or corrupt -> fresh defaults

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def put(self, key: str, value: Any) -> None:
        self._data[key] = value

    def update(self, values: dict[str, Any]) -> None:
        self._data.update(values)

    def keys(self):
        return self._data.keys()

    def save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
