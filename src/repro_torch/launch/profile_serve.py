"""Where a warm fixed-batch serving run spends its time.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [serve flags]

Takes ``launch.serve``'s flags, runs ``generate_fixed`` once cold, then
once more under ``torch.profiler`` and prints the wall time, the device
time of every kernel name (largest first), the number of device kernels
per forward pass, and the device busy share of the wall time (the sum of
kernel times over the wall time; kernels of one stream do not overlap).
On the CPU only host operators are recorded and the device lines read
"not measured".
"""
from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve
from repro_torch.serving.engine import generate_fixed


def main(argv=None, top: int = 12) -> dict:
    args = serve.parse_args(argv)
    model, params = serve.setup(args)
    cuda = model.device.type == "cuda"
    batch = serve.prompt_batch(model, args)

    def run():
        generate_fixed(model, params, batch, steps=args.steps)
        if cuda:
            torch.cuda.synchronize(model.device)

    run()                                              # cold: set-up
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6   # seconds
    launches = sum(e.count for e in kernels)
    print(f"profiled warm run: wall {wall * 1e3:.3f} ms for "
          f"{args.steps} forward passes of batch {args.batch}")
    if not kernels:
        print("device kernel time: not measured")
        return {"wall_s": wall, "busy_s": None, "kernels": {}}
    print(f"device busy {busy * 1e3:.3f} ms = {busy / wall:.1%} of wall; "
          f"{launches} device kernels ({launches / args.steps:.0f} per "
          f"forward pass)")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.self_device_time_total / 1e6 / wall:6.1%} x{e.count:<6d} "
              f"{e.key[:90]}")
    return {"wall_s": wall, "busy_s": busy, "launches": launches,
            "kernels": {e.key: e.self_device_time_total / 1e6
                        for e in kernels}}


if __name__ == "__main__":
    main()
