#!/usr/bin/env python3
"""Runs one cell of the benchmark of far3d_tpu_torch once, on the machine it
is started on, and prints the result as one JSON line, the last line of
standard output.

    python3 portbench/run.py --workload far3d_av2.stream_int8 --seed 7 \
        --seconds 20 --trace 0

The cell, its configuration, its traffic mix and its metrics are found by
name: ``BENCHMARK.json`` at the root of the checkout, then
``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``
(whose ``kind`` picks the driver, ``portbench/drivers/<kind>.py``),
``portbench/limits/<cell>.json`` and ``portbench/metrics/<metric>.py``.
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler trace of a short
window after the measured one. Every run compares what the program
produced with the plain reference (``portbench/reference``) and prints
each compared number beside its limit, last on standard error and last in
the line. Exits non-zero, printing no result, without enough CUDA cards,
or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

# every build and kernel cache of the program inside the checkout, at fixed
# paths, so that only a checkout's first run of a cell builds
os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(ROOT / 'build' / 'torch_extensions'))
os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / 'build' / 'triton_cache'))

from harness import compare, importcheck, spec  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, chips: int, peak: int) -> dict:
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips, 'memory_peak_bytes': int(peak)}


def per_layer(cell, out: dict, port_family) -> dict:
    """Each per-layer metric's reader on this run; a reader that finds
    nothing to read returns None and the metric is left out."""
    ctx = types.SimpleNamespace(
        traced=out['traced'], e2e=out['e2e'], flops=out['flops'],
        config=cell.config, family=port_family,
        backbone=cell.config['model']['backbone'], kernels=spec.kernel_names,
        brackets=spec.kernel_brackets)
    metrics = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m['name'])(ctx)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    return metrics


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.find_cell(args.workload)
    limits = spec.load_json(BENCH / 'limits' / f'{cell.name}.json')['limits']
    import torch
    torch.set_num_threads(1)     # one host thread: no spinning CPU workers
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} CUDA card(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 3
    driver = importlib.import_module(
        f"drivers.{spec.check_name(cell.traffic['kind'])}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), T_START)

    correct, rows = compare.judge(out['numbers'], limits)
    device = device_info(torch, cell.chips, out['memory_peak_bytes'])
    line = {'correct': bool(correct), 'attempted': out['attempted'],
            'failed': out['failed']}
    if args.trace:
        from harness.family import load
        line['metrics'] = per_layer(cell, out, load(cell.config, 'port'))
        trace = out['traced']['trace']
        print(f'trace: {len(trace.ops)} device ops, {trace.launches()} '
              f'kernels, {len(trace.launch_at)} host launches, labels '
              f'{sorted(trace.labels)}', file=sys.stderr)
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s())
        line['device'] = device
        line['breakdown'] = {
            'device_ops': trace.top_ops(10),
            'idle_gaps': trace.idle_gaps(10, skip=('bench.window',
                                                   'bench.frame',
                                                   'bench.step'))}
    else:
        values = dict(out['e2e'], setup_s=out['setup_s'])
        line['metrics'] = {m['name']: {'value': float(values[m['name']]),
                                       'unit': m['unit']}
                           for m in cell.end_to_end}
        line['device'] = device
    line['checks'] = {name: {'value': value, 'limit': limit}
                      for name, value, limit in rows}

    found = importcheck.forbidden_modules()
    if found:
        print(f'forbidden modules loaded in this process: {found}',
              file=sys.stderr)
        return 4
    if 'latency_ms' in out:
        print(f"frame latency ms by percentile: {out['latency_ms']}",
              file=sys.stderr)
    extra = {k: v for k, v in out['numbers'].items() if k not in limits}
    print(f'not compared: {json.dumps(extra)}', file=sys.stderr)
    for name, value, limit in rows:
        print(f'check {name}: {value!r} (limit {limit!r})', file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())
