"""Replay a recorded IQ capture through the PyTorch port and save frames.

usage: python examples/torch_replay_capture.py capture.bin 8000000 uint8 [n_frames] [--device cpu]
   or: python examples/torch_replay_capture.py capture.wav [n_frames]  (WAV autodetect)

Runs on the CUDA card by default (and raises without one); --device cpu
runs the kernels' plain PyTorch versions.
"""

import argparse
import os

import tempestsdr_tpu_torch as tsdr
from tempestsdr_tpu_torch.snapshot import save_frame

ap = argparse.ArgumentParser()
ap.add_argument("args", nargs="+")
ap.add_argument("--device", default="cuda")
opts = ap.parse_args()
args = opts.args
if len(args) >= 3:
    params = f"{args[0]} {args[1]} {args[2]}"
    n_frames = int(args[3]) if len(args) > 3 else 60
else:
    params = args[0]
    n_frames = int(args[1]) if len(args) > 1 else 60

rx = tsdr.TSDR(device=opts.device)
rx.load_source("rawfile", params)
rx.set_resolution(628, 60.0)

os.makedirs("frames", exist_ok=True)
count = [0]


def on_frame(f):
    count[0] += 1
    if count[0] % 20 == 0 or count[0] == n_frames:
        path = f"frames/frame_{count[0]:05d}.pgm"
        save_frame(f, path)
        print(f"{path}  {rx.session.meter}")


rx.start(on_frame=on_frame, max_frames=n_frames)
print("done:", rx.session.meter)
