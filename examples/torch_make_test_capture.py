"""Generate a synthetic emanation capture (uint8 raw IQ) with known
geometry, with the PyTorch port's generator (numpy only: it runs on no
device, so it takes no --device).

usage: python examples/torch_make_test_capture.py out.bin [seconds]
Geometry: 800x600@60 display -> 1056x628 VESA total, 8 MS/s receiver.
"""

import sys

import numpy as np

from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq

out = sys.argv[1] if len(sys.argv) > 1 else "capture.bin"
seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 2.0
SR = 8e6
LINES, TWIDTH, REFRESH = 628, 424, 60.0

raster = render_test_pattern(LINES, TWIDTH)
n = int(SR * seconds)
iq = synth_iq(raster, samplerate=SR, pixelclock=LINES * TWIDTH * REFRESH,
              n_samples=n, noise=0.02, dtype=np.uint8)
iq.tofile(out)
print(f"wrote {out}: {n} samples ({iq.nbytes/1e6:.1f} MB) at {SR/1e6:.0f} MS/s, "
      f"{LINES} lines @ {REFRESH:.0f} Hz")
