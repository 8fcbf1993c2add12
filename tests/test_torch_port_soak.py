"""The soak and the full-size closed loop of the port on the CPU at the tiny
config: ``cli.soak --tiny --device cpu`` (two uninterrupted runs bitwise
equal, a save / restore / resume bitwise equal to them, finite windows
across the GT-depth switch, step 0's gradient norm and the parameters that
carry it), and ``cli.overfit_full --tiny --device cpu`` for a few steps
with one evaluation through the eval path, on the tiny learnable dataset."""

import json

import numpy as np

from far3d_tpu_torch.cli import overfit_full, soak


def test_soak_tiny(tmp_path):
    log = tmp_path / 'soak.jsonl'
    rc = soak.main(['--tiny', '--device', 'cpu', '--iters', '12',
                    '--switch-at', '6', '--resume-iters', '4',
                    '--log', str(log), '--work', str(tmp_path / 'ckpt')])
    assert rc == 0
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [w['iter'] for w in lines] == [6, 10]
    assert [w['use_gt_depth'] for w in lines] == [True, False]
    assert all(np.isfinite([w['loss'], w['grad_norm'], w['s_per_it']]).all()
               for w in lines)


def test_soak_resume_checks_compare_everything(tmp_path):
    out = soak.run_soak(iters=2, switch_at=1, resume_iters=2,
                        log=str(tmp_path / 'soak.jsonl'),
                        work=str(tmp_path / 'ckpt'), tiny=True, device='cpu')
    res = out['resume']
    assert out['ok'] and not res['repeat_diffs'] and not res['resume_diffs']
    # parameters and buffers, both Adam moments and their step counts, step
    state, _ = soak.Soak(soak.build_config(True, 1), 'cpu').fresh(0)
    n_params = len(list(state.model.named_parameters()))
    n_trained = sum(p.requires_grad for p in state.model.parameters())
    assert res['compared'] == (len(state.model.state_dict())
                               + 3 * n_trained + 1) and n_trained < n_params
    step0 = out['stability']['step0']
    assert np.isfinite(step0['grad_norm']) and len(step0['carriers']) == 5
    # a step that differs is found
    a = soak.snapshot(state)
    state.model.pts_bbox_head.reference_points.weight.data[0, 0] += 1
    assert soak.differences(a, soak.snapshot(state)) == [
        'model.pts_bbox_head.reference_points.weight']


def test_overfit_full_tiny(tmp_path):
    rc = overfit_full.main(['--tiny', '--device', 'cpu', '--work',
                            str(tmp_path), '--iters', '4',
                            '--eval-every', '4'])
    assert rc == 0
    curve = [json.loads(x) for x in
             (tmp_path / 'curve.jsonl').read_text().splitlines()]
    assert [c['iter'] for c in curve] == [4]
    assert np.isfinite([curve[0]['mAP'], curve[0]['CDS']]).all()
    assert (tmp_path / '4.pt').exists()
    cfg = overfit_full.build_config(2500, 500)
    assert (cfg.train.lr, cfg.train.warmup_iters, cfg.train.use_grid_mask,
            cfg.train.use_gt_depth_until_iter, cfg.train.checkpoint_every,
            cfg.train.log_every) == (1e-3, 100, False, 1250, 500, 50)
