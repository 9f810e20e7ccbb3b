"""Status codes and exceptions.

Mirrors the 12 status codes of the reference C core
(TempestSDR/src/include/TSDRCodes.h:16-27) and the per-code Java exception
classes (JavaGUI/src/martin/tempest/core/exceptions/). Here they are one enum
plus one exception type carrying the code — idiomatic Python instead of 12
classes marshalled over JNI.
"""

from __future__ import annotations

import enum


class TSDRStatus(enum.IntEnum):
    OK = 0
    ERR_PLUGIN = 1
    INCOMPATIBLE_PLUGIN = 2
    PLUGIN_PARAMETERS_WRONG = 3
    SAMPLE_RATE_WRONG = 4
    CANNOT_OPEN_DEVICE = 5
    WRONG_VIDEOPARAMS = 6
    ALREADY_RUNNING = 7
    NOT_RUNNING = 8
    INVALID_PARAMETER = 9
    INVALID_PARAMETER_VALUE = 10
    CANNOT_TUNE = 11
    NOT_IMPLEMENTED = 404


class TSDRError(Exception):
    """Raised by the framework API; carries a TSDRStatus like the reference's
    typed Java exceptions (JavaGUI/jni/TSDRLibraryNDK.c:47-107)."""

    def __init__(self, status: TSDRStatus, message: str = ""):
        self.status = TSDRStatus(status)
        super().__init__(f"[{self.status.name}] {message}")
