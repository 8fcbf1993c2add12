"""BENCHMARK.json against the contract's forms, and every cell,
configuration, traffic mix, limit and per-layer metric found by name from
its own file."""

import json
import re
import shutil

import pb_tiny
from harness import spec

BENCH = json.loads((pb_tiny.ROOT / 'BENCHMARK.json').read_text())
NAME = spec.NAME
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


def test_names_and_units_use_the_allowed_characters():
    names = [c['name'] for c in BENCH['configs']]
    names += [w[k] for w in BENCH['workloads']
              for k in ('name', 'config', 'traffic')]
    names += [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    names += [k for c in BENCH['configs'] for k in c['reduced']]
    assert all(NAME.match(n) for n in names), names
    units = [m['unit'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert all(UNIT.match(u) for u in units), units
    for text in ([c['why'] for c in BENCH['configs']]
                 + [w['why'] for w in BENCH['workloads']]
                 + [m['layer'] for m in BENCH['per_layer']]):
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_every_cell_finds_its_files():
    for w in BENCH['workloads']:
        cell = spec.find_cell(w['name'])
        assert cell.traffic['kind'] in ('stream', 'train')
        assert (pb_tiny.BENCH / 'drivers' / f"{cell.traffic['kind']}.py").is_file()
        assert (pb_tiny.BENCH / 'families'
                / f"{cell.config['family']}.py").is_file()
        limits = pb_tiny.limits(w['name'])
        assert limits['limits'] and 'control' in limits
        e2e = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m['moves'] in e2e


def test_every_metric_has_a_reader_and_every_table_names_kernels():
    for m in BENCH['per_layer']:
        assert callable(spec.metric_reader(m['name']))
    for op in ('msda_fwd', 'msda_bwd', 'qconv'):
        assert spec.kernel_names(op)


def test_a_new_cell_is_picked_up_from_new_files_alone(tmp_path):
    root = tmp_path
    shutil.copytree(pb_tiny.BENCH, root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = json.loads((pb_tiny.ROOT / 'BENCHMARK.json').read_text())
    bench['workloads'].append({'name': 'far3d_av2.stream_bf16',
                               'config': 'far3d_av2',
                               'traffic': 'av2_stream_bf16', 'chips': 1,
                               'why': 'a cell added by files alone'})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    mix = json.loads((pb_tiny.BENCH / 'traffic' /
                      'av2_stream_int8.json').read_text())
    mix['backbone'] = 'bf16'
    (root / 'portbench' / 'traffic' / 'av2_stream_bf16.json').write_text(
        json.dumps(mix))
    cell = spec.find_cell('far3d_av2.stream_bf16', root)
    assert cell.traffic['backbone'] == 'bf16'
    assert cell.config_name == 'far3d_av2'
    assert 'setup_s' in {m['name'] for m in cell.end_to_end}


def test_configs_build_the_port_and_the_reference_alike():
    from harness import family
    for c in BENCH['configs']:
        config = spec.load_json(pb_tiny.ROOT / c['file'])
        port = family.load(config, 'port').cfg
        ref = family.load(config, 'reference').cfg
        assert repr(port).split('(', 1)[1] == repr(ref).split('(', 1)[1]
