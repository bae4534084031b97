"""Write tests/fixtures/torch_policy_episode.npz: the JAX package's greedy
episode of the committed GAIL policy (gail_policy.msgpack, flax, float32)
on MoveToRegion-Demo-LoRes4E-v0, which tests/test_torch_policy_episode.py
holds magical_tpu_torch's own closed-loop episode against.

B = 2 Demo resets from PRNGKey(0); at every step the policy's logits on
that step's observation and the greedy action it takes, then the step.
The file holds:
  logits      (T, B, 18) float32, the policy's logits at each step
  done        (T, B) bool
  score       (B,) the end scores
  obs_steps   the steps whose observations are kept
  obs         (len(obs_steps) * B, 96, 96, 12) uint8, those observations

Run (about fifteen seconds on the CPU, most of it XLA compiling the step):

    JAX_PLATFORMS=cpu MAGICAL_TPU_PALLAS=0 python tests/_torch_policy_episode_fixture.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault('MAGICAL_TPU_PALLAS', '0')

OUT = os.path.join(REPO, 'tests', 'fixtures', 'torch_policy_episode.npz')
POLICY = os.path.join(REPO, 'gail_policy.msgpack')
ENV = 'MoveToRegion-Demo-LoRes4E-v0'
B = 2
OBS_STEPS = (0, 10, 20, 39)


def main():
    import flax.serialization
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from magical_tpu.api.batched_env import BatchedEnv
    from magical_tpu.models.nets import MagicalCNN

    with open(POLICY, 'rb') as f:
        raw = flax.serialization.msgpack_restore(f.read())
    net = MagicalCNN(with_value_head=True, dtype=jnp.float32)
    template = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 96, 96, 12), jnp.uint8))
    params = meta.unbox(flax.serialization.from_state_dict(template, raw))
    apply = jax.jit(net.apply)
    env = BatchedEnv(ENV)
    carry, obs = env.reset(jax.random.split(jax.random.PRNGKey(0), B))
    logits, done, kept = [], [], []
    for t in range(env.max_episode_steps):
        lg = np.asarray(apply(params, obs)[0])
        logits.append(lg)
        if t in OBS_STEPS:
            kept.append(np.asarray(obs))
        carry, obs, _, d, info = env.step(
            carry, jnp.asarray(lg.argmax(-1), jnp.int32))
        done.append(np.asarray(d))
    np.savez_compressed(
        OUT, logits=np.stack(logits), done=np.stack(done),
        score=np.asarray(info['eval_score']),
        obs_steps=np.asarray(OBS_STEPS), obs=np.concatenate(kept))
    print(f'wrote {OUT}: end scores {np.asarray(info["eval_score"])}')


if __name__ == '__main__':
    main()
