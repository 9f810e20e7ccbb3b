"""Load a compiled TempestSDR plugin binary (.so) as the signal source of
the PyTorch port.

Users migrating from the reference keep their existing TSDRPlugin_*.so
files working unchanged — the `cplugin` source dlopens the 10-function C
plugin ABI (TSDRPlugin.h:49-60) and streams through it.

usage: python examples/torch_reference_plugin.py /path/to/TSDRPlugin_RawFile.so \\
           "capture.bin 8000000 uint8" [--device cpu]
(the second argument is the plugin's own params string, e.g. the RawFile
plugin's "filename samplerate format")
"""

import argparse

import tempestsdr_tpu_torch as tsdr

ap = argparse.ArgumentParser()
ap.add_argument("so_path")
ap.add_argument("plugin_params")
ap.add_argument("--device", default="cuda")
opts = ap.parse_args()
so_path, plugin_params = opts.so_path, opts.plugin_params

rx = tsdr.TSDR(device=opts.device)
# block=1 applies backpressure into the plugin callback (drop-free file
# replay); omit it for live sources so a stalled consumer drops whole
# chunks instead (CB_FULL semantics)
rx.load_source("cplugin", f"{so_path} block=1 -- {plugin_params}")
print(f"loaded: {rx._source.name()} @ {rx._source.samplerate()/1e6:.1f} MS/s")

rx.set_resolution(628, 60.0)
frames = []
rx.start(on_frame=frames.append, max_frames=8)
print(f"streamed {len(frames)} frames of {frames[-1].shape} "
      "through the reference plugin binary")
