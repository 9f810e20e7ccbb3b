"""Monitor several independent targets on one card with the PyTorch port's
MultiSession (BASELINE config 5 as a product API — the reference's JNI
layer is a singleton and can only ever drive one receiver per process).

usage: python examples/torch_multi_target.py [n_targets] [--device cuda|cpu]

Runs on the CUDA card by default (and raises without one); --device cpu
runs the kernels' plain PyTorch versions.
"""

import argparse

from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource
from tempestsdr_tpu_torch.stream import MultiSession

ap = argparse.ArgumentParser()
ap.add_argument("n_targets", type=int, nargs="?", default=3)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
C = args.n_targets
SR, LINES, REFRESH = 1e6, 100, 50.0

sources = []
for c in range(C):
    s = SyntheticSource()
    s.init(f"{LINES} {200 + 8 * c} {REFRESH} {SR} 0.02")  # distinct emitters
    sources.append(s)

cfg = PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH,
                     block_samples=8192, autocorr=False)
last = {}


def on_frame(channel, frame):
    last[channel] = frame


ms = MultiSession(cfg, Params(framerate_pll=False), sources, on_frame=on_frame,
                  device=args.device)
ms.run(max_frames=4 * C)

print(f"{C} targets on {ms.device}, frames per channel: {ms.frames_total}")
for c in sorted(last):
    f = last[c]
    print(f"  target {c}: frame {f.shape}, range [{f.min():.3f}, {f.max():.3f}]")
assert len(last) == C
