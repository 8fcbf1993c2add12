"""The port's data-preparation tools and Feather reader against the JAX
package's tools, on the CPU.

* ``cli.create_nusc_infos`` against ``tools/create_nusc_infos.py`` on the
  raw-table fixture of tests/test_nuscenes.py:60-130: equal info pickles;
* ``cli.info2coco`` against ``tools/info2coco.py`` on
  tests/test_data.py's fake infos (the fixture of tests/test_info2coco.py):
  equal JSON;
* ``cli.create_av2_infos`` against ``tools/create_av2_infos.py`` on a small
  AV2 log layout whose tables pandas writes, uncompressed and with LZ4:
  equal info pickles;
* ``utils/feather.py:read_feather`` against ``pandas.read_feather`` column
  by column (int64, float64, utf8 and the other widths it reads, several
  record batches, uncompressed and LZ4), and a ZSTD file raising by name.

"Equal" is exact: the same keys, types, dtypes and values throughout.
"""

import json
import pickle
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pandas as pd
import pytest

from far3d_tpu_torch.cli import create_av2_infos as port_av2
from far3d_tpu_torch.cli import create_nusc_infos as port_nusc
from far3d_tpu_torch.cli import info2coco as port_coco
from far3d_tpu_torch.utils.feather import read_feather

TOOLS = Path(__file__).resolve().parents[1] / 'tools'


def jax_tool(name):
    sys.path.insert(0, str(TOOLS))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(TOOLS))


def assert_same(got, want, where='info'):
    """Exact structural equality of two unpickled trees."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (where, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f'{where}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, (
            where, got.dtype, want.dtype, got.shape, want.shape)
        assert got.tolist() == want.tolist(), where
    else:
        assert got == want, (where, got, want)


# ------------------------------------------------------------------ nuScenes

def write_nusc_tables(root: Path):
    """tests/test_nuscenes.py:60-130's raw v1.0-mini tables: one scene of
    two keyframes, a lidar and two cameras, a moving car and an object of an
    unmapped category."""
    v = root / 'v1.0-mini'
    v.mkdir()
    ident_q = [1.0, 0.0, 0.0, 0.0]

    def write(name, rows):
        (v / f'{name}.json').write_text(json.dumps(rows))

    write('scene', [dict(token='sc0', name='scene-0001', log_token='log0')])
    write('sensor', [
        dict(token='se_lidar', channel='LIDAR_TOP', modality='lidar'),
        dict(token='se_cf', channel='CAM_FRONT', modality='camera'),
        dict(token='se_cb', channel='CAM_BACK', modality='camera')])
    intr = [[800.0, 0.0, 800.0], [0.0, 800.0, 450.0], [0.0, 0.0, 1.0]]
    write('calibrated_sensor', [
        dict(token='cs_lidar', sensor_token='se_lidar', rotation=ident_q,
             translation=[0, 0, 1.8], camera_intrinsic=[]),
        dict(token='cs_cf', sensor_token='se_cf',
             rotation=[0.5, -0.5, 0.5, -0.5], translation=[1.5, 0, 1.5],
             camera_intrinsic=intr),
        dict(token='cs_cb', sensor_token='se_cb',
             rotation=[0.5, 0.5, -0.5, -0.5], translation=[-1.5, 0, 1.5],
             camera_intrinsic=intr)])
    samples, sds, eps = [], [], []
    for i, ts in enumerate([1000000, 1500000]):
        samples.append(dict(token=f's{i}', scene_token='sc0', timestamp=ts,
                            prev='' if i == 0 else f's{i-1}',
                            next='' if i == 1 else f's{i+1}'))
        eps.append(dict(token=f'ep{i}', rotation=ident_q,
                        translation=[2.0 * i, 0, 0], timestamp=ts))
        for ch, cs in (('lidar', 'cs_lidar'), ('cf', 'cs_cf'),
                       ('cb', 'cs_cb')):
            sds.append(dict(
                token=f'sd_{ch}{i}', sample_token=f's{i}',
                calibrated_sensor_token=cs, ego_pose_token=f'ep{i}',
                is_key_frame=True, timestamp=ts,
                filename=f'samples/{ch}/{i}.jpg'))
    write('sample', samples)
    write('sample_data', sds)
    write('ego_pose', eps)
    write('category', [dict(token='cat_car', name='vehicle.car'),
                       dict(token='cat_x', name='static_object.bicycle_rack')])
    write('instance', [dict(token='inst0', category_token='cat_car'),
                       dict(token='inst1', category_token='cat_x')])
    anns = []
    for i in range(2):
        anns.append(dict(
            token=f'a{i}', sample_token=f's{i}', instance_token='inst0',
            translation=[12.0 + 2.0 * i + 2.0 * i, 0.0, 0.9],
            size=[2.0, 4.5, 1.6], rotation=ident_q,
            prev='' if i == 0 else f'a{i-1}',
            next='' if i == 1 else f'a{i+1}', num_lidar_pts=10))
    anns.append(dict(token='ax', sample_token='s0', instance_token='inst1',
                     translation=[5, 5, 0.5], size=[1, 1, 1],
                     rotation=ident_q, prev='', next='', num_lidar_pts=3))
    write('sample_annotation', anns)


@pytest.mark.parametrize('no_2d', [False, True], ids=['with_2d', 'no_2d'])
def test_create_nusc_infos_matches_jax_tool(tmp_path, no_2d):
    write_nusc_tables(tmp_path)
    argv = ['--data-root', str(tmp_path), '--version', 'v1.0-mini']
    argv += ['--no-2d'] if no_2d else []
    jax_out, port_out = tmp_path / 'jax.pkl', tmp_path / 'port.pkl'
    tool = jax_tool('create_nusc_infos')
    with mock.patch.object(sys, 'argv',
                           ['x', *argv, '--out', str(jax_out)]):
        tool.main()
    port_nusc.main([*argv, '--out', str(port_out)])
    want = pickle.loads(jax_out.read_bytes())
    got = pickle.loads(port_out.read_bytes())
    assert len(want['infos']) == 2
    assert ('annos' in want['infos'][0]) is not no_2d
    assert_same(got, want)


# ----------------------------------------------------------------- info2coco

def test_info2coco_matches_jax_tool(tmp_path):
    from test_data import make_fake_infos
    ann = tmp_path / 'infos.pkl'
    make_fake_infos(ann, n_scenes=2, frames_per_scene=3, n_cams=3)
    jax_out, port_out = tmp_path / 'jax.json', tmp_path / 'port.json'
    tool = jax_tool('info2coco')
    with mock.patch.object(sys, 'argv', ['x', '--ann-file', str(ann),
                                         '--out', str(jax_out)]):
        tool.main()
    port_coco.main(['--ann-file', str(ann), '--out', str(port_out)])
    assert len(json.loads(jax_out.read_text())['annotations']) == 2 * 3 * 3
    assert port_out.read_text() == jax_out.read_text()


# ----------------------------------------------------------------------- AV2

CAMS = port_av2.RING_CAMERAS


def quat_z(yaw):
    return [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]


def write_av2_log(split_dir: Path, name: str, rng, compression: str):
    """One AV2 sensor log: 4 lidar sweeps 100 ms apart with cameras at
    20 Hz (the last sweep's cameras too late, so it is dropped), an ego
    pose table, per-camera calibration and intrinsics, and cuboids around
    the ego at every sweep (one an unknown category)."""
    log = split_dir / name
    (log / 'calibration').mkdir(parents=True)
    t0 = 315966000000000000 + int(rng.integers(0, 1000)) * 1000
    sweeps = [t0 + i * 100_000_000 for i in range(4)]
    pose_ts = [t0 + i * 50_000_000 for i in range(9)]
    rng.shuffle(pose_ts)                    # the tool sorts them
    q = np.array([quat_z(0.05 * i) for i in range(9)])
    pd.DataFrame(dict(
        timestamp_ns=np.array(pose_ts, np.int64),
        qw=q[:, 0], qx=q[:, 1], qy=q[:, 2], qz=q[:, 3],
        tx_m=rng.uniform(-5, 5, 9), ty_m=rng.uniform(-5, 5, 9),
        tz_m=rng.uniform(0, 1, 9))).to_feather(
            log / 'city_SE3_egovehicle.feather', compression=compression)
    calib, intr = [], []
    for i, cam in enumerate(CAMS):
        yaw = 2 * np.pi * i / len(CAMS)
        # camera axes (z forward, x right, y down) looking out at `yaw`
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        rot = np.stack([right, [0, 0, -1.0], fwd], axis=1)
        w = 0.5 * np.sqrt(1 + np.trace(rot))
        qc = [w, (rot[2, 1] - rot[1, 2]) / (4 * w),
              (rot[0, 2] - rot[2, 0]) / (4 * w),
              (rot[1, 0] - rot[0, 1]) / (4 * w)]
        calib.append(dict(sensor_name=cam, qw=qc[0], qx=qc[1], qy=qc[2],
                          qz=qc[3], tx_m=1.0, ty_m=0.0, tz_m=1.6))
        portrait = cam == 'ring_front_center'
        h, wd = (2048, 1550) if portrait else (1550, 2048)
        intr.append(dict(sensor_name=cam, fx_px=1700.0, fy_px=1700.0,
                         cx_px=wd / 2, cy_px=h / 2, width_px=wd,
                         height_px=h))
        cam_dir = log / 'sensors' / 'cameras' / cam
        cam_dir.mkdir(parents=True)
        for t in range(t0 - 10_000_000, sweeps[2] + 60_000_000, 50_000_000):
            (cam_dir / f'{t}.jpg').touch()
    pd.DataFrame(calib).to_feather(
        log / 'calibration' / 'egovehicle_SE3_sensor.feather',
        compression=compression)
    pd.DataFrame(intr).to_feather(log / 'calibration' / 'intrinsics.feather',
                                  compression=compression)
    lidar = log / 'sensors' / 'lidar'
    lidar.mkdir(parents=True)
    rows = []
    cats = ['REGULAR_VEHICLE', 'PEDESTRIAN', 'BUS', 'MYSTERY_OBJECT']
    for ts in sweeps:
        (lidar / f'{ts}.feather').touch()
        for k in range(6):
            yaw = rng.uniform(-np.pi, np.pi)
            qa = quat_z(yaw)
            r = rng.uniform(8, 30)
            a = rng.uniform(-np.pi, np.pi)
            rows.append(dict(
                timestamp_ns=ts, track_uuid=f'track-{k}',
                category=cats[k % len(cats)], length_m=rng.uniform(1, 6),
                width_m=rng.uniform(0.5, 2.5), height_m=rng.uniform(1, 3),
                qw=qa[0], qx=qa[1], qy=qa[2], qz=qa[3],
                tx_m=r * np.cos(a), ty_m=r * np.sin(a),
                tz_m=rng.uniform(0, 2),
                num_interior_pts=int(rng.integers(0, 500))))
    pd.DataFrame(rows).to_feather(log / 'annotations.feather',
                                  compression=compression)


@pytest.mark.parametrize('compression', ['uncompressed', 'lz4'])
def test_create_av2_infos_matches_jax_tool(tmp_path, compression):
    rng = np.random.default_rng(0)
    for name in ('log-a', 'log-b'):
        write_av2_log(tmp_path / 'val', name, rng, compression)
    jax_out, port_out = tmp_path / 'jax.pkl', tmp_path / 'port.pkl'
    tool = jax_tool('create_av2_infos')
    argv = ['--data-root', str(tmp_path), '--split', 'val']
    with mock.patch.object(sys, 'argv', ['x', *argv, '--out', str(jax_out)]):
        tool.main()
    port_av2.main([*argv, '--out', str(port_out)])
    want = pickle.loads(jax_out.read_bytes())
    got = pickle.loads(port_out.read_bytes())
    assert len(want['infos']) == 2 * 3          # the 4th sweep has no cams
    assert sum(len(b) for i in want['infos']
               for b in i['gt2d_infos']['gt_2dbboxes']) > 0
    assert_same(got, want)


# -------------------------------------------------------------------- reader

def feather_frame(n, rng):
    return pd.DataFrame({
        'timestamp_ns': rng.integers(0, 2**62, n, dtype=np.int64),
        'tx_m': rng.standard_normal(n),
        'category': rng.choice(['REGULAR_VEHICLE', 'BUS', '', 'über'], n),
        'i32': rng.integers(-9, 9, n).astype(np.int32),
        'u8': rng.integers(0, 255, n).astype(np.uint8),
        'f32': rng.standard_normal(n).astype(np.float32)})


@pytest.mark.parametrize('compression', ['uncompressed', 'lz4'])
@pytest.mark.parametrize('chunk', [None, 7], ids=['one_batch', 'batches'])
def test_read_feather_matches_pandas(tmp_path, compression, chunk):
    rng = np.random.default_rng(1)
    df = feather_frame(50 if chunk else 3000, rng)
    path = tmp_path / 'x.feather'
    df.to_feather(path, compression=compression, chunksize=chunk)
    want = pd.read_feather(path)
    got = read_feather(str(path))
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        assert got[c].tolist() == w.tolist(), c


def test_read_feather_of_an_empty_table(tmp_path):
    path = tmp_path / 'x.feather'
    feather_frame(0, np.random.default_rng(2)).to_feather(path)
    got = read_feather(str(path))
    assert all(len(v) == 0 for v in got.values()) and 'category' in got


def test_read_feather_refuses_zstd_by_name(tmp_path):
    path = tmp_path / 'x.feather'
    feather_frame(20, np.random.default_rng(3)).to_feather(
        path, compression='zstd')
    with pytest.raises(ValueError, match='ZSTD'):
        read_feather(str(path))
