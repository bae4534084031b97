"""The learner cell `gail-mtr` on the CPU, at 4 envs and 2 expert episodes:
the harness finds it by name; a run, untraced and traced, is correct and
every reader of the cell gives a number; the control and each planted
fault fail the check; the work count follows the networks' shapes.  (One
iteration on the CPU takes ~30 s: the env's plain physics dominates.)"""

import dataclasses
import math
import types

import pytest
import torch

from portbench import learner_faults
from portbench.harness import bench, check, learner, spec
from portbench.work import learner as work

CELL = 'gail-mtr'
SEED = 2 ** 31 + 1021


def cell():
    c = spec.cell(CELL)
    return dataclasses.replace(c, traffic=c.traffic | {'expert_episodes': 2})


def run(traced=False, **kw):
    return bench.run_cell(cell(), SEED, math.inf, traced, device='cpu',
                          batch=4, episodes=1, **kw)


def test_the_learner_cell_is_found_by_name():
    c = spec.cell(CELL)
    assert c.env_id == 'MoveToRegion-Demo-LoRes4E-v0'
    assert (c.chips, c.traffic['loop'], c.traffic['batch']) == (1, 'gail',
                                                                256)
    assert [m['name'] for m in c.end_to_end] == ['train_samples_per_s',
                                                 'setup_s']
    assert [m['name'] for m in c.per_layer] == [
        'learner_collect_ms', 'learner_ppo_ms', 'learner_disc_ms',
        'learner_mfu']
    assert set(c.traffic['limits']) == set(learner.NUMBERS)


def test_an_untraced_run_is_correct_and_its_control_is_not():
    r = run(control=True)
    assert r['correct'], r['checks']
    assert set(r['metrics']) == {'train_samples_per_s', 'setup_s'}
    assert r['window']['iterations'] == 1
    assert r['attempted'] == 4 * 40
    assert not check.verdict(r['control'], cell().traffic['limits'],
                             learner.NUMBERS), \
        r['control']


def test_a_frozen_discriminator_is_checked_as_frozen():
    # an accuracy can never lie at or under -1: every step is frozen, and
    # the check reads the frozen branch (parameters and Adam state kept)
    c = cell()
    c = dataclasses.replace(c, config=c.config | {
        'learner': c.config['learner'] | {'disc_freeze_acc': -1.0}})
    r = learner.run_cell(c, SEED, math.inf, False, device='cpu', batch=4,
                         episodes=1, detail=True)
    assert r['correct'], r['checks']
    assert r['window']['disc_steps_taken'] == 0
    assert all(d['disc'][3] is None for d in r['detail']['program'].values())


def test_a_traced_run_is_correct_and_reads_its_share_of_the_peak():
    # the CPU's trace has no device operations: the device readers read
    # nothing there, and the synthetic trace below holds them
    r = run(traced=True)
    assert r['correct'], r['checks']
    assert set(r['metrics']) == {'learner_mfu'}
    assert r['metrics']['learner_mfu']['value'] > 0


def ev(name, ts, dur, cat='user_annotation', tid=1, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'tid': tid, 'args': args}


def op(name, ts, dur, corr):
    return ev(name, ts, dur, cat='kernel', tid=7, correlation=corr)


def launch(ts, corr, tid=1):
    return ev('cudaLaunchKernel', ts, 1, cat='cuda_runtime', tid=tid,
              correlation=corr)


EVENTS = [
    ev('learner.iteration', 0, 300),
    ev('learner.collect', 0, 100),
    ev('learner.disc', 60, 20),              # the reward's forward
    ev('learner.ppo', 100, 100),
    ev('learner.disc', 200, 100),
    ev('learner.disc', 210, 10),             # its forward inside
    launch(5, 1), launch(65, 2), launch(110, 3),
    launch(150, 4, tid=2),                   # a backward's, on another thread
    launch(250, 5, tid=2),
    op('step_kernel', 10, 40, 1),
    op('conv_reward', 70, 10, 2),
    op('conv_fwd', 120, 20, 3),
    op('conv_bwd', 160, 30, 4),              # 20 µs idle before it
    op('adam', 260, 5, 5),
]


def test_learner_readers_hold_hand_computed_values():
    t = learner.attribute(EVENTS)
    ctx = types.SimpleNamespace(trace=t, iterations=2, flops=2e12,
                                host_s=0.5, peak_flops=1e15)

    def read(name):
        return spec.load_metric(name).read(ctx)
    assert read('learner_collect_ms') == pytest.approx(40 / 2 / 1e3)
    assert read('learner_ppo_ms') == pytest.approx(50 / 2 / 1e3)
    assert read('learner_disc_ms') == pytest.approx(15 / 2 / 1e3)
    assert read('learner_mfu') == pytest.approx(0.4)
    assert t.window == (0, 265)
    assert t.busy_us == 105
    assert dict(t.gaps)['learner.ppo'] == 20


@pytest.mark.parametrize('fault', sorted(learner_faults.FAULTS))
def test_a_broken_learner_fails_the_check(fault):
    with learner_faults.planted(fault):
        r = run()
    assert not r['correct'], r['checks']


def test_the_work_count_follows_the_shapes():
    c = spec.cell(CELL)
    cfg, tr = c.config, c.traffic
    pf, pb = work.net_flops(cfg['policy'], 96, 12, 18, False)
    df, db = work.net_flops(cfg['discriminator'], 96, 12, 18, True)
    conv0 = 2 * 25 * 12 * 64 * 48 * 48
    assert pf == (conv0 + 2 * 9 * 64 * 128 * 24 * 24
                  + 2 * 9 * 128 * 128 * 12 * 12 + 2 * 9 * 128 * 256 * 6 * 6
                  + 2 * 256 * 256 + 2 * 256 * 19)
    assert pb == 2 * pf - conv0
    assert df == (2 * 9 * 12 * 64 * 48 * 48 + 2 * 9 * 64 * 128 * 24 * 24
                  + 2 * 9 * 128 * 128 * 12 * 12 + 2 * 146 * 256 + 2 * 256)
    n = 256 * 40
    frozen = work.iteration_flops(cfg, tr, (96, 96, 12), 0)
    assert frozen == 41 * 256 * pf + n * df + 4 * n * (pf + pb) \
        + (2048 + 1280) * df
    assert work.iteration_flops(cfg, tr, (96, 96, 12), 1) - frozen \
        == (2048 + 1280) * db


def test_the_weights_fit_the_program_and_repeat_from_the_seed():
    from magical_tpu_torch.models.nets import Discriminator, MagicalCNN
    cfg = spec.cell(CELL).config
    pol, disc = learner.make_weights(cfg, 12, SEED, 'cpu')
    MagicalCNN(18, widths=cfg['policy']['widths'],
               with_value_head=True).load_state_dict(pol)
    Discriminator(18, widths=cfg['discriminator']['widths']
                  ).load_state_dict(disc)
    again, _ = learner.make_weights(cfg, 12, SEED, 'cpu')
    assert all(torch.equal(pol[k], again[k]) for k in pol)
