"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the readers of its per-layer metrics
(``metrics/<metric>.py``) and the kernel-name tables they read
(``kernels/<op>/*.txt``). Nothing here knows a cell, a configuration or a
metric by name, so a later change adds one by adding files and entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from typing import Any, Dict, List, Tuple

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that is missing or
    malformed."""


def load_json(path: pathlib.Path) -> Dict[str, Any]:
    if not path.is_file():
        raise SpecError(f'{path} is missing')
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> Dict[str, Any]:
    return load_json(root / 'BENCHMARK.json')


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f'{name!r} is not a legal name')
    return name


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with what it names, read from its files."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]           # configs/<config>.json
    traffic_name: str
    traffic: Dict[str, Any]          # traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics it reports
    per_layer: List[Dict[str, Any]]   # the per-layer metrics it reports


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def find_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell `name` of ``BENCHMARK.json`` under `root`, its configuration
    and traffic read from their files under ``portbench/``."""
    spec = benchmark(root)
    cells = {w['name']: w for w in spec['workloads']}
    if name not in cells:
        raise SpecError(f'no workload {name!r} in BENCHMARK.json '
                        f'(have {sorted(cells)})')
    w = cells[name]
    configs = {c['name']: c for c in spec['configs']}
    cfg_entry = configs[check_name(w['config'])]
    bench = root / 'portbench'
    config = load_json(root / cfg_entry['file'])
    traffic = load_json(bench / 'traffic' / f"{check_name(w['traffic'])}.json")
    return Cell(name, int(w['chips']), w['config'], config, w['traffic'],
                traffic,
                [m for m in spec['end_to_end'] if _reports(m, name)],
                [m for m in spec['per_layer'] if _reports(m, name)])


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = root / 'portbench' / 'metrics' / f'{check_name(name)}.py'
    if not path.is_file():
        raise SpecError(f'no reader {path} for per-layer metric {name!r}')
    mod_spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name.replace(".", "_").replace("-", "_")}', path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _kernel_lines(op: str, root: pathlib.Path) -> List[str]:
    folder = root / 'portbench' / 'kernels' / check_name(op)
    return [ln.strip() for path in sorted(folder.glob('*.txt'))
            for ln in path.read_text().splitlines()
            if ln.strip() and not ln.startswith('#')]


def kernel_names(op: str, root: pathlib.Path = ROOT) -> List[str]:
    """Every kernel name listed for `op` under ``portbench/kernels/<op>/``:
    one file per implementation, one name (a part of the demangled kernel
    name in the trace) per line. A later change that implements the op
    another way adds a file."""
    names = [ln for ln in _kernel_lines(op, root) if ' .. ' not in ln]
    if not names:
        raise SpecError(f'no kernel names for {op!r} under '
                        f'portbench/kernels/{op}')
    return names


def kernel_brackets(op: str, root: pathlib.Path = ROOT
                    ) -> List[Tuple[str, str]]:
    """The lines ``<first> .. <last>`` of `op`'s kernel files: every
    kernel that runs after a `first` kernel and before the next `last`
    kernel belongs to the op too (a library kernel the op launches between
    two of its own)."""
    return [tuple(ln.split(' .. ')) for ln in _kernel_lines(op, root)
            if ' .. ' in ln]


def build_dataclass(cls, values: Dict[str, Any]):
    """`cls` (a frozen config dataclass of the port or of the reference)
    from its ``dataclasses.asdict`` form: nested dataclasses by their
    defaults' types, lists back to tuples. A key the class lacks raises."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in values.items():
        if key not in fields:
            raise SpecError(f'{cls.__name__} has no field {key!r}')
        f = fields[key]
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        if dataclasses.is_dataclass(default):
            value = build_dataclass(type(default), value)
        elif isinstance(default, tuple):
            value = _tuples(value)
        kwargs[key] = value
    return cls(**kwargs)


def _tuples(value):
    if isinstance(value, list):
        return tuple(_tuples(v) for v in value)
    return value
