"""Where a warm serving run spends its time.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [serve flags]

Takes ``launch.serve``'s flags (or, through ``profile_fixed`` and
``profile_arrivals``, a model built by the caller).  Fixed batch: runs
``generate_fixed`` once cold, then once more under ``torch.profiler``.
With ``--arrival-rate``: runs the arrival mode's warm-up request, then its
timed arrivals under ``torch.profiler``.  Prints the wall time, the device
time of every kernel name (largest first), the device busy share of the
wall time (the sum of kernel times over the wall time; kernels of one
stream do not overlap), and the TT kernels found in the trace against the
launches expected; for the arrival mode also the admissions' share of the
wall (host clock) and the device time of the decode step's per-row
``torch.where`` KV writes, or, on a paged pool (``--paged``), of its
block-table copies: the k/v scatter into each layer's arenas and the
gathers of each row's logical cache through its table.  On a card the
prefills and the decode steps are replays of captured CUDA graphs.  On a
card only device kernels are traced; on the CPU only host operators are
recorded and the device lines read "not measured".  The TT launches
expected follow the model: mamba2-2.7b's are its SSD in/out projections, 2
a layer, 128 a pass (``--arch mamba2-2.7b --tt ffn``).
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
    if args.arrival_rate:
        return profile_arrivals(model, params, args, top)
    return profile_fixed(model, params, args, top)


# seconds the trace stays open after the traced run has ended
RECORDS_S = 0.5
# spin kernels that open every trace on a card and are left out of its
# report: the profiler drops the first records of a trace, one more with
# each trace the process has taken, and these take that loss in place of
# the traced run's own kernels
PREROLL = 1024
SPIN_KERNEL = "spin_kernel"
# the device kernel of each source, by the wrappers that launch it
TT_KERNELS = {"tt_fused2_kernel": ("tt_fused2", "tt_fused2_int8"),
              "tt_fused2_experts_kernel": ("tt_fused2_experts",
                                           "tt_fused2_experts_int8"),
              "tt_chain_kernel": ("tt_fused_chain", "tt_fused_chain_int8"),
              "tt_step_kernel": ("tt_step", "tt_step_int8")}
# the device kernel of ``torch.where``: in serving, only the per-row
# writes of the slot pool's decode step (two per layer and step: k and v,
# or an SSM block's masked state and conv history, ``ssm.ssm_decode``)
WHERE_KERNEL = "where_kernel"
# the device kernels of the paged pool's block-table copies: ``index_put_``
# (the step's k/v scatter into the arenas, two per layer and step, and a
# full-prompt admission's scatter of its row, two per layer) and the
# gathers ``arena[table]`` (two per layer and step; also every pass's
# embedding lookup)
SCATTER_KERNEL = "index_elementwise_kernel"
GATHER_KERNEL = "vectorized_gather_kernel"


def preroll() -> None:
    """Open a trace on a card with the ``PREROLL`` spin kernels."""
    for _ in range(PREROLL):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def device_kernels(prof) -> list:
    """The trace's device kernels but the pre-roll's, by name, largest
    device time first."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and SPIN_KERNEL not in e.key]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return kernels


def _report(kernels, wall: float, expected: dict, top: int) -> dict:
    """Print the device busy share, the ``top`` kernels and the TT kernels
    found against ``expected``; return them."""
    busy = sum(e.self_device_time_total for e in kernels) / 1e6   # seconds
    launches = sum(e.count for e in kernels)
    print(f"device busy {busy * 1e3:.3f} ms = {busy / wall:.1%} of wall; "
          f"{launches} device kernels")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.self_device_time_total / 1e6 / wall:6.1%} x{e.count:<6d} "
              f"{e.key[:90]}")
    tt = {}
    for kernel, names in TT_KERNELS.items():
        found = sum(e.count for e in kernels if kernel in e.key)
        want = sum(expected.get(n, 0) for n in names)
        if found or want:
            tt[kernel] = {"found": found, "expected": want}
            print(f"{kernel} in the trace: {found} of {want} expected")
    return {"wall_s": wall, "busy_s": busy, "launches": launches,
            "tt_kernels": tt,
            "kernels": {e.key: e.self_device_time_total / 1e6
                        for e in kernels}}


def profile_fixed(model, params, args, top: int = 12,
                  steps: int | None = None) -> dict:
    """Profile one warm ``generate_fixed`` run of ``model`` with the batch,
    prompt and cache of the serve flags ``args`` and ``steps`` forward
    passes (default ``--steps``; fewer keep the cache, so the same graphs,
    and shorten the trace): on a card the prefill and the decode steps are
    replays of captured graphs, and the TT kernels found in the trace are
    held against the launches expected (counted by the wrappers, plus
    those each capture recorded times its replays)."""
    cuda = model.device.type == "cuda"
    batch = serve.prompt_batch(model, args)
    steps = args.steps if steps is None else steps

    def run():
        generate_fixed(model, params, batch, steps=steps)
        if cuda:
            torch.cuda.synchronize(model.device)

    run()                                              # cold: set-up
    # on a card only the device is traced: host tracing would slow the
    # host-bound loop it measures, and its events take long to summarise
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    before = serve.tally(model)
    with profile(activities=acts) as prof:
        if cuda:
            preroll()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        if cuda:
            # the device's records of the last kernels reach the profiler
            # after the kernels end; let them arrive before it stops
            time.sleep(RECORDS_S)
    expected = serve.launches_between(before, serve.tally(model))
    kernels = device_kernels(prof)
    print(f"profiled warm run: wall {wall * 1e3:.3f} ms for "
          f"{steps} forward passes of batch {args.batch}")
    if not kernels:
        print("device kernel time: not measured")
        return {"wall_s": wall, "busy_s": None, "kernels": {}}
    out = _report(kernels, wall, expected, top)
    print(f"{out['launches'] / steps:.0f} device kernels per forward pass")
    return out


def profile_arrivals(model, params, args, top: int = 12) -> dict:
    """Profile the arrival mode's timed arrivals (``launch.serve.arrivals``)
    after its warm-up request, on the serve flags ``args``: the device busy
    share of their wall, the admissions' share of it (host clock), and the
    device time and count of the per-row ``torch.where`` KV writes and of
    the block-table scatters and gathers (``SCATTER_KERNEL``,
    ``GATHER_KERNEL``); the TT
    kernels in the trace are held against the launches expected (counted by
    the wrappers, plus each capture's per replay of it: the admission
    prefills' and the decode steps')."""
    cuda = model.device.type == "cuda"
    sched, _ = serve.arrival_scheduler(model, params, args)
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        if cuda:
            preroll()
        run = serve.arrivals(sched, args)
        if cuda:
            time.sleep(RECORDS_S)
    wall = run["wall_s"]
    kernels = device_kernels(prof)
    print(f"profiled arrivals: wall {wall * 1e3:.3f} ms, "
          f"{run['admissions']} admissions ({run['admit_share']:.1%} of the "
          f"wall), {run['steps_run']} decode steps")
    if not kernels:
        print("device kernel time: not measured")
        return dict(run, busy_s=None, kernels={})
    out = _report(kernels, wall, run["launches"], top)
    for name, kernel, what in (
            ("where", WHERE_KERNEL, "per-row cache writes"),
            ("scatter", SCATTER_KERNEL, "block-table scatters"),
            ("gather", GATHER_KERNEL,
             "block-table gathers and embedding lookups")):
        found = [e for e in kernels if kernel in e.key]
        out[f"{name}_s"] = sum(e.self_device_time_total
                               for e in found) / 1e6
        out[f"{name}_count"] = sum(e.count for e in found)
        print(f"{what} ({kernel}): {out[f'{name}_count']} kernels, "
              f"{out[f'{name}_s'] * 1e3:.3f} ms of device time "
              f"({out[f'{name}_s'] / out['busy_s']:.1%} of busy)")
    return dict(run, **out)

if __name__ == "__main__":
    main()
