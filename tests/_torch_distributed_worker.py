"""Worker program for tests/test_torch_parallel.py.

Launched as one of N ``torch.distributed`` ranks on the CPU (gloo), it
drives magical_tpu_torch's data-parallel path (parallel/multihost.py,
parallel/mesh.py, parallel/rollout.py, the trainers' `mesh`) and writes
what it saw for the parent test to compare across ranks and against the
JAX package.  It imports torch and numpy only.

Usage: _torch_distributed_worker.py <coord> <nproc> <rank> <inputs dir>
           <out.json> <out.npz> [gail]

The inputs directory holds ``early.npz`` (the rollouts' action table) at
launch; ``learner.npz`` (the learner's initial parameters and batches) may
come later: each rank runs its env checks first and waits for it then, so
the parent computes the JAX package's side meanwhile.
"""
import hashlib
import json
import os
import sys
import time

LEARNER_WAIT_S = 600
# a collective that one rank reaches and another never does (ranks that
# took different branches) fails after this rather than hanging
COLLECTIVE_TIMEOUT_S = 120


def _bytes_equal(a, b):
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def check_resets(multihost):
    """Each rank's reset rows against a one-process reset of the global
    batch, field by field, bit for bit."""
    import numpy as np

    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.core.convert import state_to_numpy
    out = {}
    for name in ('MoveToRegion-TestAll-v0', 'ClusterColour-TestAll-v0'):
        env = BatchedEnv(name, render_enabled=False, device='cpu')
        gen, local, start = multihost.host_local_seeds(11, 8)
        carry, _ = env.reset(gen, local, global_batch=8, start=start)
        full, _ = env.reset(11, 8)
        got, want = state_to_numpy(carry.state), state_to_numpy(full.state)
        out[name] = {'start': start, 'local': local, 'fields': len(want),
                     'equal': [k for k in want if _bytes_equal(
                         got[k], np.ascontiguousarray(
                             want[k][start:start + local]))]}
    return out


def check_rollouts(mesh, inputs):
    """The gathered end scores of a table-driven MoveToRegion-Demo
    rollout, the gathered scores of two steps of a random-policy
    MoveToRegion-TestAll rollout, and the random policy's actions against
    a one-process draw."""
    import torch

    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.parallel import mesh as M
    from magical_tpu_torch.parallel.rollout import (random_policy,
                                                    rollout_episodes)
    table = torch.from_numpy(inputs['action_table'])
    local, start = M.data_rows(mesh, table.shape[1])
    steps = iter(range(table.shape[0]))

    def from_table(obs, generator):
        return table[next(steps), start:start + local]

    env = BatchedEnv('MoveToRegion-Demo-v0', render_enabled=False,
                     device='cpu')
    table_scores = rollout_episodes(env, from_table, 0, table.shape[1],
                                    mesh=mesh)
    env = BatchedEnv('MoveToRegion-TestAll-v0', render_enabled=False,
                     device='cpu')
    random_scores = rollout_episodes(env, None, 5, 8, mesh=mesh, length=2)
    # the random policy's actions: this rank's rows of the global draw
    rows = random_policy(local, 8, start)(
        None, torch.Generator().manual_seed(9))
    whole = random_policy(8)(None, torch.Generator().manual_seed(9))
    return {'table_scores': table_scores.tolist(),
            'random_scores': random_scores.tolist(),
            'random_actions_are_rows': bool(torch.equal(
                rows, whole[start:start + local]))}


def bc_step(mesh, inputs, arrays):
    """One data-parallel BC step from the given parameters, each rank on
    its rows of the global batch; its parameters after the step go to
    `arrays`."""
    import torch

    from magical_tpu_torch.parallel import mesh as M
    from magical_tpu_torch.train.bc import BCTrainer
    obs, acts = inputs['bc_obs'], inputs['bc_acts']
    tr = BCTrainer(obs.shape[1:], widths=tuple(inputs['bc_widths']),
                   dtype=torch.float32, device='cpu', mesh=mesh)
    tr.net.load_state_dict({k[3:]: torch.from_numpy(v)
                            for k, v in inputs.items()
                            if k.startswith('bc/')})
    m = tr.train_step(*M.shard_batch((obs, acts), mesh))
    for k, v in tr.net.state_dict().items():
        arrays[f'bc/{k}'] = v.numpy()
    return {'loss': float(m['loss']), 'acc': float(m['acc']),
            'local_rows': int(M.shard_batch(acts, mesh).shape[0])}


def _gail_trainer(mesh, inputs, **kw):
    import torch

    from magical_tpu_torch.train.gail import GAILTrainer
    widths = tuple(inputs['gail_widths'])
    tr = GAILTrainer(None, inputs['gail_exp_obs'].shape[1:],
                     policy_widths=widths, disc_widths=widths,
                     dtype=torch.float32, device='cpu', mesh=mesh, **kw)
    for net, pre in ((tr.policy, 'gail_policy/'), (tr.disc, 'gail_disc/')):
        net.load_state_dict({k[len(pre):]: torch.from_numpy(v)
                             for k, v in inputs.items()
                             if k.startswith(pre)})
    return tr


def _digest(*modules_and_opts):
    digest = hashlib.sha256()
    for m in modules_and_opts:
        if hasattr(m, 'state_dict') and hasattr(m, 'param_groups'):
            for s in m.state_dict()['state'].values():
                for v in s.values():
                    digest.update(v.numpy().tobytes())
        else:
            for v in m.state_dict().values():
                digest.update(v.numpy().tobytes())
    return digest.hexdigest()


def gail_steps(mesh, inputs, arrays):
    """GAIL's learner steps over the data ranks, each rank on its columns
    of one global (T, B) rollout, from the given parameters: a PPO step
    on the whole rollout and one on a minibatch of global indices, and a
    discriminator step that is taken; the parameters after each go to
    `arrays`.  Then a discriminator step whose freeze threshold lies
    between the ranks' own accuracies, so only the accuracy over every
    rank's samples decides it."""
    import torch

    from magical_tpu_torch.parallel import mesh as M
    B = inputs['gail_traj/last_value'].shape[0]
    local, start = M.data_rows(mesh, B)
    traj = {k[len('gail_traj/'):]: torch.from_numpy(
                v[start:start + local] if v.ndim == 1
                else v[:, start:start + local])
            for k, v in inputs.items() if k.startswith('gail_traj/')}
    out = {}
    for case, idx in (('ppo', None), ('ppo_idx', inputs['gail_idx'])):
        tr = _gail_trainer(mesh, inputs, entropy_coef=0.02)
        m = tr.ppo_update(traj, None if idx is None
                          else torch.from_numpy(idx))
        out[case] = {k: float(v) for k, v in m.items()}
        for k, v in tr.policy.state_dict().items():
            arrays[f'{case}/{k}'] = v.numpy()
    exp_obs = torch.from_numpy(inputs['gail_exp_obs'])
    exp_act = torch.from_numpy(inputs['gail_exp_act'])
    idx_p = torch.from_numpy(inputs['gail_idx_p'])
    idx_e = torch.from_numpy(inputs['gail_idx_e'])
    tr = _gail_trainer(mesh, inputs, disc_freeze_acc=1.0)
    m = tr.disc_update(traj['obs'], traj['act'], idx_p, exp_obs, exp_act,
                       idx_e)
    out['disc'] = {k: float(v) for k, v in m.items()}
    out['disc']['steps'] = [int(s['step']) for s in
                            tr.disc_opt.state_dict()['state'].values()]
    for k, v in tr.disc.state_dict().items():
        arrays[f'disc/{k}'] = v.numpy()

    # this rank's own accuracy on its samples, and the threshold between
    # the two ranks' own
    tr = _gail_trainer(mesh, inputs)
    T = traj['obs'].shape[0]
    mine_p = tr._local_samples(idx_p, T, local)
    mine_e = idx_e.tensor_split(M.data_size(mesh))[M.data_rank(mesh)]
    with torch.no_grad():
        pol = tr.disc(traj['obs'].reshape((-1,) + exp_obs.shape[1:])[mine_p],
                      traj['act'].reshape(-1)[mine_p])
        exp = tr.disc(exp_obs[mine_e], exp_act[mine_e])
    own = 0.5 * float((exp > 0).float().mean() + (pol <= 0).float().mean())
    owns = [None] * M.data_size(mesh)
    torch.distributed.all_gather_object(owns, own)
    tr.disc_freeze_acc = 0.5 * (min(owns) + max(owns))
    m = tr.disc_update(traj['obs'], traj['act'], idx_p, exp_obs, exp_act,
                       idx_e)
    out['split_freeze'] = {
        'own_accs': owns, 'threshold': tr.disc_freeze_acc,
        'acc': float(m['disc_acc']),
        'taken': bool(tr.disc_opt.state_dict()['state']),
        'digest': _digest(tr.disc, tr.disc_opt)}
    return out


def split_logits(multihost):
    """MagicalCNN with fc split by column over a 1 x N mesh against the
    same network whole, on the same observations."""
    import torch

    from magical_tpu_torch.models.nets import MagicalCNN
    from magical_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(model_parallel=multihost.process_count())

    def net():
        return MagicalCNN(widths=(16, 32), dtype=torch.float32,
                          with_value_head=True,
                          generator=torch.Generator().manual_seed(3))
    whole, split = net(), net().split_fc(mesh)
    obs = torch.randint(0, 256, (6, 24, 24, 12), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        (lw, vw), (ls, vs) = whole(obs), split(obs)
    shard = {k: [str(p) for p in v]
             for k, v in M.param_sharding(mesh, split).items()}
    return {'local_fc_rows': int(split.fc.weight.to_local().shape[0]),
            'split_placements': shard,
            'whole_placements': sorted({str(p) for v in M.param_sharding(
                mesh, whole).values() for p in v}),
            'data_sharding': [str(p) for p in M.data_sharding(mesh)],
            'replicated': [str(p) for p in M.replicated(mesh)],
            'max_logit': float(lw.abs().max()),
            'max_diff': float((lw - ls).abs().max()),
            'value_diff': float((vw - vs).abs().max())}


def gail_iteration(mesh):
    """One whole GAIL iteration (collect, PPO, discriminator) at the real
    96 x 96 x 12 shape over the data ranks; a digest of every parameter
    and optimiser state after it."""
    import numpy as np
    import torch

    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.train.gail import GAILTrainer
    env = BatchedEnv('MoveToRegion-Demo-LoRes4E-v0', device='cpu')
    tr = GAILTrainer(env, (96, 96, 12), rollout_len=3,
                     policy_widths=(32, 64), disc_widths=(32, 64),
                     dtype=torch.float32, disc_freeze_acc=0.5, mesh=mesh)
    rng = np.random.default_rng(7)
    exp_obs = rng.integers(0, 256, (8, 96, 96, 12), dtype=np.uint8)
    exp_act = rng.integers(0, 18, 8).astype(np.int32)
    out = tr.train(3, exp_obs, exp_act, iterations=1, batch_envs=4,
                   disc_batch=8, ppo_epochs=2, verbose=False)
    steps = [int(s['step']) for s in tr.disc_opt.state_dict()['state']
             .values()]
    return {'digest': _digest(tr.policy, tr.disc, tr.policy_opt,
                              tr.disc_opt),
            'disc_acc': float(out['disc']['disc_acc']),
            'disc_frozen': not steps,
            'pg': float(out['ppo']['pg']),
            'finite': bool(all(torch.isfinite(p).all() for p in
                               (*tr.policy.parameters(),
                                *tr.disc.parameters())))}


def main():
    coord, nproc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    inputs_dir, out_json, out_npz = sys.argv[4:7]
    gail = 'gail' in sys.argv[7:]

    import numpy as np
    import torch
    torch.set_num_threads(1)

    from magical_tpu_torch.parallel import mesh as M
    from magical_tpu_torch.parallel import multihost

    assert multihost.initialize(coord, nproc, rank,
                                timeout=COLLECTIVE_TIMEOUT_S)
    assert multihost.process_count() == nproc
    mesh = M.make_mesh()
    result = {'rank': rank, 'world': multihost.process_count(),
              'mean_across_hosts': float(
                  multihost.mean_across_hosts(float(rank)))}
    arrays = {}
    if gail:
        result['gail'] = gail_iteration(mesh)
    else:
        inputs = dict(np.load(os.path.join(inputs_dir, 'early.npz')))
        result['resets'] = check_resets(multihost)
        result.update(check_rollouts(mesh, inputs))
        learner = os.path.join(inputs_dir, 'learner.npz')
        t0 = time.monotonic()
        while not os.path.exists(learner):
            if time.monotonic() - t0 > LEARNER_WAIT_S:
                raise TimeoutError(f'no {learner}')
            time.sleep(0.05)
        inputs.update(np.load(learner))
        result['bc'] = bc_step(mesh, inputs, arrays)
        result['gail_steps'] = gail_steps(mesh, inputs, arrays)
        result['split'] = split_logits(multihost)
    np.savez(out_npz, **arrays)
    with open(out_json, 'w') as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
