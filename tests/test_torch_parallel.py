"""magical_tpu_torch's data-parallel path over two gloo ranks on the CPU,
held against one process and against the JAX package.

One launch of two ranks of tests/_torch_distributed_worker.py does every
rank-side check (the module-scoped fixture); the tests read its result:

- each rank's reset rows are the one-process reset's rows, bit for bit;
- `rollout_episodes` gathers the same scores on both ranks, equal to the
  JAX package's `rollout_episodes` under a one-device mesh fed the same
  action table (MoveToRegion-Demo without rendering: the robot alone, no
  contacts), and the random policy's actions are each rank's rows of one
  draw for the global batch;
- after one data-parallel BC step from JAX's initial parameters, each rank
  on its half of the batch, the parameters are bitwise equal across ranks
  and within float32 tolerance of JAX's one-device step on the whole
  batch, compared where the gradient is clear of 0 (Adam's first step is
  lr·sign(g), and a gradient within rounding of 0 may flip its sign);
- GAIL's learner over the two ranks, each on its columns of one rollout,
  from JAX's initial parameters: a PPO step on the whole rollout and one
  on a minibatch, and a discriminator step that is taken, each bitwise
  equal across ranks and within float32 tolerance of JAX's one-device
  step on the whole rollout (compared as BC's is); and a discriminator
  step whose freeze threshold lies between the ranks' own accuracies,
  taken or skipped alike on both, as the accuracy over both decides;
- MagicalCNN with `fc` split by column over a 1 x 2 mesh gives the whole
  network's logits.

The ranks run their env checks first; the parent computes JAX's side
meanwhile and hands the learner's inputs over in a file.

The `slow` test runs a whole GAIL iteration over the two ranks at the
real 96 x 96 x 12 shape (the counterpart of tests/test_sharding.py's
test_gail_iteration_over_mesh).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.core import meta

from magical_tpu import constants as JC
from magical_tpu.api.batched_env import BatchedEnv as JaxEnv
from magical_tpu.models import nets as JN
from magical_tpu.parallel import mesh as JM
from magical_tpu.parallel import rollout as JR
from magical_tpu.train import bc as JBC
from magical_tpu.train import gail as JG
from magical_tpu_torch.models.convert import params_from_flax

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, '_torch_distributed_worker.py')
NPROC = 2
OBS = (24, 24, 12)
WIDTHS = (16, 32)
BC_BATCH = 8
LR = 3e-4
# tests/test_torch_train.py's float32 tolerance of a parameter after one
# Adam step, where |g| is above GRAD_REL of the largest |g| of its tensor
PARAM_ATOL = 2e-6
GRAD_REL = 1e-3
LOGIT_RTOL = 1e-6
T_TABLE = 40            # MoveToRegion's episode
# GAIL's global rollout (T, B), each rank its B / NPROC columns
GT, GB = 8, 8
GAIL_LR = {'ppo': 3e-4, 'ppo_idx': 3e-4, 'disc': 1e-4}
RTOL = 1e-5             # tests/test_torch_train.py's, for the losses
A = {n: i for i, n in enumerate(JC.ACTION_NAMES)}


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _action_table():
    """Env b turns right for b + 2 steps, then drives forward: envs 2 and
    4 end in the goal (one on each rank), the others do not."""
    table = np.full((T_TABLE, 8), A['UpOpen'], np.int32)
    for b in range(8):
        table[:b + 2, b] = A['RightOpen']
    return table


def _bc_inputs():
    """JAX's BC trainer in float32 at WIDTHS, its initial state, and the
    global batch."""
    jt = JBC.BCTrainer(obs_shape=OBS, lr=LR)
    jt.net = JN.MagicalCNN(widths=WIDTHS, dtype=jnp.float32)
    state = jax.jit(jt.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    obs = rng.integers(0, 256, (BC_BATCH,) + OBS, dtype=np.uint8)
    acts = rng.integers(0, 18, BC_BATCH).astype(np.int32)
    return jt, state, obs, acts


def _port_sd(params):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(params))).items()}


def _jax_gail(**kw):
    jt = JG.GAILTrainer(None, obs_shape=OBS, **kw)
    jt.policy = JN.MagicalCNN(with_value_head=True, widths=WIDTHS,
                              dtype=jnp.float32)
    jt.disc = JN.Discriminator(widths=WIDTHS, dtype=jnp.float32)
    return jt


def _gail_inputs():
    """A seeded global (GT, GB) rollout with dones, expert samples and
    the indices of a minibatch and of a discriminator batch."""
    rng = np.random.default_rng(5)
    done = np.zeros((GT, GB), bool)
    done[3, 1] = done[7, :] = done[5, 6] = True
    traj = {'obs': rng.integers(0, 256, (GT, GB) + OBS, dtype=np.uint8),
            'act': rng.integers(0, 18, (GT, GB)).astype(np.int32),
            'logp': -rng.uniform(2.0, 3.5, (GT, GB)).astype(np.float32),
            'value': rng.normal(0, 1, (GT, GB)).astype(np.float32),
            'done': done,
            'reward': rng.normal(0, 1, (GT, GB)).astype(np.float32),
            'last_value': rng.normal(0, 1, (GB,)).astype(np.float32)}
    return {'traj': traj,
            'idx': rng.permutation(GT * GB)[:24],
            'exp_obs': rng.integers(0, 256, (10,) + OBS, dtype=np.uint8),
            'exp_act': rng.integers(0, 18, 10).astype(np.int32),
            'idx_p': rng.choice(GT * GB, 24, replace=False),
            'idx_e': rng.choice(10, 6, replace=False)}


def _adam_grads(opt_state):
    """The gradient of a first optax.adam step, from its first moment
    (mu = (1 - b1)·g)."""
    return {k: v / 0.1 for k, v in _port_sd(opt_state[0].mu).items()}


def _jax_side(write_learner):
    """JAX's side of every check: the learner's inputs (handed to the
    ranks through `write_learner` as soon as they exist), then JAX's
    one-device steps on the global batches and its rollout scores."""
    jt, state, obs, acts = _bc_inputs()
    g = _gail_inputs()
    jg = _jax_gail(entropy_coef=0.02)
    gstate = jax.jit(jg.init)(jax.random.PRNGKey(0))
    learner = {'bc_obs': obs, 'bc_acts': acts,
               'bc_widths': np.asarray(WIDTHS),
               'gail_widths': np.asarray(WIDTHS),
               **{f'gail_traj/{k}': v for k, v in g['traj'].items()},
               **{f'gail_{k}': v for k, v in g.items() if k != 'traj'}}
    learner.update({f'bc/{k}': v for k, v in _port_sd(state.params).items()})
    learner.update({f'gail_policy/{k}': v for k, v in
                    _port_sd(gstate.policy_params).items()})
    learner.update({f'gail_disc/{k}': v for k, v in
                    _port_sd(gstate.disc_params).items()})
    write_learner(learner)

    ref = {}

    def loss_fn(params):
        logits = jt.net.apply(params, obs)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, acts[:, None], 1)[:, 0].mean()
    after, m = jt.train_step(state, jnp.asarray(obs), jnp.asarray(acts))
    ref['bc'] = (_port_sd(after.params),
                 _port_sd(jax.jit(jax.grad(loss_fn))(state.params)),
                 {'loss': float(m['loss']), 'acc': float(m['acc'])})
    jtraj = {k: jnp.asarray(v) for k, v in g['traj'].items()}
    for case, idx in (('ppo', None), ('ppo_idx', g['idx'])):
        after, m = jg._ppo_update(gstate, jtraj, None if idx is None
                                  else jnp.asarray(idx))
        ref[case] = (_port_sd(after.policy_params),
                     _adam_grads(after.policy_opt),
                     {k: float(v) for k, v in m.items()})
    jd = _jax_gail(disc_freeze_acc=1.0)
    after, m = jd._disc_update(gstate, jtraj['obs'], jtraj['act'],
                               *(jnp.asarray(g[k]) for k in
                                 ('idx_p', 'exp_obs', 'exp_act', 'idx_e')))
    ref['disc'] = (_port_sd(after.disc_params), _adam_grads(after.disc_opt),
                   {k: float(v) for k, v in m.items()})

    env = JaxEnv('MoveToRegion-Demo-v0', render_enabled=False)
    key = jax.random.PRNGKey(0)
    # the policy keys rollout_episodes hands out, to look up the step
    pkeys = jax.random.split(jax.random.split(key)[1], T_TABLE)
    jtable = jnp.asarray(_action_table())

    def policy(obs, k):
        return jtable[jnp.argmax(jnp.all(pkeys == k, axis=-1))]
    ref['table_scores'] = np.asarray(JR.rollout_episodes(
        env, policy, key, 8, mesh=JM.make_mesh(n_devices=1)))
    return ref


def _launch(tmp, jax_side=None, extra=()):
    """Run NPROC ranks of the worker; with `jax_side`, compute it while
    they run.  Returns ([(json, npz) per rank], jax_side's result)."""
    coord = f'127.0.0.1:{_free_port()}'
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''), OMP_NUM_THREADS='1')
    np.savez(str(tmp / 'early.npz'), action_table=_action_table())
    outs = [(str(tmp / f'rank{r}.json'), str(tmp / f'rank{r}.npz'))
            for r in range(NPROC)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, str(NPROC), str(r), str(tmp),
         *outs[r], *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(NPROC)]

    def write_learner(arrays):
        np.savez(str(tmp / 'learner.tmp.npz'), **arrays)
        os.replace(tmp / 'learner.tmp.npz', tmp / 'learner.npz')
    ref = None
    try:
        if jax_side is not None:
            ref = jax_side(write_learner)
        logs = []
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out.decode(errors='replace'))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f'rank failed:\n{log[-4000:]}'
    results = []
    for js, npz in outs:
        with open(js) as f:
            results.append((json.load(f), dict(np.load(npz))))
    return results, ref


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp('torch_parallel'), _jax_side)


@pytest.fixture(scope='module')
def ranks(launched):
    return launched[0]


@pytest.fixture(scope='module')
def ref(launched):
    return launched[1]


def _assert_one_adam_step(got, want, grads, lr, prefix):
    """Parameters after one Adam step within PARAM_ATOL of JAX's where
    |g| is clear of 0, and within one step's reach everywhere."""
    for k, w in want.items():
        d = np.abs(got[f'{prefix}/{k}'] - w)
        g = np.abs(grads[k])
        sure = g > GRAD_REL * g.max()
        assert sure.any(), k
        assert d[sure].max() <= PARAM_ATOL, k
        assert d.max() <= 2 * lr + PARAM_ATOL, k


def test_both_ranks_ran_in_one_group(ranks):
    for r, (res, _) in enumerate(ranks):
        assert res['rank'] == r and res['world'] == NPROC
        assert res['mean_across_hosts'] == 0.5


@pytest.mark.parametrize('name', ['MoveToRegion-TestAll-v0',
                                  'ClusterColour-TestAll-v0'])
def test_rank_resets_are_rows_of_the_global_reset(ranks, name):
    starts = []
    for res, _ in ranks:
        got = res['resets'][name]
        assert got['local'] == 8 // NPROC
        assert len(got['equal']) == got['fields'], got
        starts.append(got['start'])
    assert starts == [0, 4]


def test_rollout_scores_match_jax(ranks, ref):
    """The gathered scores: the same on both ranks and equal to JAX's
    rollout_episodes on the same action table."""
    want = ref['table_scores']
    assert want.tolist() == [0, 0, 1, 0, 1, 0, 0, 0]
    for res, _ in ranks:
        np.testing.assert_array_equal(np.asarray(res['table_scores']), want)


def test_random_rollout_does_not_depend_on_the_ranks(ranks):
    for res, _ in ranks:
        assert len(res['random_scores']) == 8
        assert res['random_actions_are_rows']
    assert ranks[0][0]['random_scores'] == ranks[1][0]['random_scores']


def test_bc_step_bitwise_across_ranks(ranks):
    (r0, a0), (r1, a1) = ranks
    assert r0['bc']['local_rows'] == r1['bc']['local_rows'] == BC_BATCH // 2
    assert r0['bc']['loss'] == r1['bc']['loss']
    assert r0['bc']['acc'] == r1['bc']['acc']
    assert a0.keys() == a1.keys() and a0
    for k in a0:
        assert a0[k].tobytes() == a1[k].tobytes(), k


def test_bc_step_matches_jax_on_the_global_batch(ranks, ref):
    want, grads, m = ref['bc']
    res, got = ranks[0]
    np.testing.assert_allclose(res['bc']['loss'], m['loss'], rtol=RTOL)
    assert res['bc']['acc'] == m['acc']
    _assert_one_adam_step(got, want, grads, LR, 'bc')


@pytest.mark.parametrize('case', ['ppo', 'ppo_idx', 'disc'])
def test_gail_step_bitwise_across_ranks(ranks, case):
    (r0, a0), (r1, a1) = ranks
    assert r0['gail_steps'][case] == r1['gail_steps'][case]
    keys = [k for k in a0 if k.startswith(case + '/')]
    assert keys and keys == [k for k in a1 if k.startswith(case + '/')]
    for k in keys:
        assert a0[k].tobytes() == a1[k].tobytes(), k


@pytest.mark.parametrize('case', ['ppo', 'ppo_idx', 'disc'])
def test_gail_step_matches_jax_on_the_global_rollout(ranks, ref, case):
    """PPO (the advantage normalised over both ranks' rollout, each loss
    a rank's share of the global mean) and the discriminator (its
    accuracy over both ranks' samples; the step is taken) against JAX's
    one-device step on the whole rollout."""
    want, grads, m = ref[case]
    res, got = ranks[0]
    mine = res['gail_steps'][case]
    for k, v in m.items():
        if k == 'disc_acc':
            assert mine[k] == v
        else:
            np.testing.assert_allclose(mine[k], v, rtol=RTOL, atol=1e-7,
                                       err_msg=k)
    if case == 'disc':
        assert mine['steps'] and set(mine['steps']) == {1}
    _assert_one_adam_step(got, want, grads, GAIL_LR[case], case)


def test_disc_freeze_is_decided_on_every_ranks_accuracy(ranks):
    """The threshold lies between the two ranks' own accuracies, so a
    rank-local decision would part them: both take the branch that the
    accuracy over both ranks' samples gives, and stay bitwise equal."""
    s0, s1 = (res['gail_steps']['split_freeze'] for res, _ in ranks)
    lo, hi = min(s0['own_accs']), max(s0['own_accs'])
    assert s0['own_accs'] == s1['own_accs'] and lo < s0['threshold'] < hi
    assert s0['acc'] == s1['acc']
    assert s0['taken'] == s1['taken'] == (not s0['acc'] > s0['threshold'])
    assert s0['digest'] == s1['digest']


def test_fc_split_over_model_keeps_the_logits(ranks):
    for res, _ in ranks:
        s = res['split']
        assert s['local_fc_rows'] == 256 // NPROC
        assert s['max_diff'] <= LOGIT_RTOL * s['max_logit'], s
        assert s['value_diff'] <= LOGIT_RTOL * s['max_logit'], s
        # the placements: fc by column over 'model', the rest replicated
        split = s['split_placements']
        assert split['fc.weight'] == split['fc.bias'] == ['R', 'S(0)']
        assert all(v == ['R', 'R'] for k, v in split.items()
                   if not k.startswith('fc.'))
        assert s['whole_placements'] == ['R']
        assert s['data_sharding'] == ['S(0)', 'R']
        assert s['replicated'] == ['R', 'R']


@pytest.mark.slow
def test_gail_iteration_over_two_ranks(tmp_path):
    """One whole GAIL iteration (collect, 2 PPO steps, the discriminator)
    over two ranks at 96 x 96 x 12: every parameter and Adam state bitwise
    equal across the ranks afterwards, the freeze decided alike."""
    ((r0, _), (r1, _)), _ = _launch(tmp_path, extra=('gail',))
    g0, g1 = r0['gail'], r1['gail']
    assert g0['finite'] and g1['finite']
    assert g0['disc_frozen'] == g1['disc_frozen']
    assert g0['disc_acc'] == g1['disc_acc'] and g0['pg'] == g1['pg']
    assert g0['digest'] == g1['digest']
