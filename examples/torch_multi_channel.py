"""Config 5 with the PyTorch port: N independent emitters, channel data
parallel over torch.distributed ranks (make_channel_step). The script
starts its own gloo ranks on this host ("spawn" start method); each rank
runs its block of channels on its device, with no collective in steady
state.

usage: python examples/torch_multi_channel.py [n_channels] [--ranks R] [--device cuda|cpu]

R (default 2) must divide n_channels. On "cuda" rank r takes card
r % cards (several ranks may share one card under gloo); --device cpu
runs the kernels' plain PyTorch versions.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.parallel import make_channel_step, make_mesh, stack_states
from tempestsdr_tpu_torch.parallel.launch import RankPool
from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq
from tempestsdr_tpu_torch.stream.pipeline import StepControls

SR, LINES, TWIDTH, REFRESH = 1e6, 100, 200, 50.0


def rank_main(C, n_ranks, device):
    """One rank: its channels' blocks, stepped 40 times; the last frame of
    each of its channels."""
    if device == "cuda":
        device = f"cuda:{torch.distributed.get_rank() % torch.cuda.device_count()}"
    cfg = PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH,
                         block_samples=8192, autocorr=False)
    mesh = make_mesh(n_channel=n_ranks, n_time=1, device=device)
    step = make_channel_step(cfg, Params(framerate_pll=False), mesh, C)
    per = C // n_ranks
    mine = list(range(mesh.ch_index * per, (mesh.ch_index + 1) * per))
    states = stack_states(cfg, per, device=device)
    # each channel watches a different emitter (different random pattern)
    rasters = {c: render_test_pattern(LINES, TWIDTH, seed=c) for c in mine}
    pos = 0
    frames = {}
    for b in range(40):
        raws = torch.from_numpy(np.stack([
            synth_iq(rasters[c], samplerate=SR, pixelclock=LINES * TWIDTH * REFRESH,
                     n_samples=cfg.block_samples, start_sample=pos, noise=0.01, seed=c)
            for c in mine]))
        pos += cfg.block_samples
        states, outs = step(states, raws, StepControls())
        for i in np.nonzero(outs.frame_valid.cpu().numpy())[0]:
            frames[mine[i]] = outs.frame[i].cpu().numpy()
    return mesh.shape, str(mesh.device), frames


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n_channels", type=int, nargs="?", default=4)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    C, R = args.n_channels, args.ranks
    if C % R:
        ap.error(f"--ranks {R} must divide n_channels {C}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        with RankPool(R, init_method=f"file://{os.path.join(tmp, 'rdv')}") as pool:
            results = pool.run(rank_main, C, R, args.device)
    shape = results[0][0]
    frames = {c: f for _, _, fr in results for c, f in fr.items()}
    devices = sorted({d for _, d, _ in results})
    print(f"{C} channels over {R} ranks, mesh {shape} on {devices}: "
          f"{len(frames)} channels produced frames")
    for c, f in sorted(frames.items()):
        print(f"  channel {c}: frame range [{f.min():.2f}, {f.max():.2f}]")
