"""Write tests/fixtures/torch_jax_demo.pkl.gz: one episode of
MoveToRegion-Demo-LoRes4E-v0 under the scripted policy below, recorded by
the JAX package's own CLI (``python -m magical_tpu --policy
_torch_tools_fixture:scripted --record DIR``): the demo that
tests/test_torch_tools.py re-records on the port and records again with
the port's CLI.

The policy turns right for 4 steps, drives forward into the goal for 11
and turns on the spot there to the end (score 1), clear of the walls,
the grippers open throughout.  A wall's contact, the fingers' when the
grippers close, or the fingers swinging as the robot brakes make the two
engines' float rounding diverge within ~10 steps, past any frame
tolerance (the ego view turns with the robot); random actions do all
three.  On this script the poses stay within ~3e-5 of JAX's.

    JAX_PLATFORMS=cpu MAGICAL_TPU_PALLAS=0 python tests/_torch_tools_fixture.py
"""
import glob
import os
import shutil
import subprocess
import sys
import tempfile

# the reference's action table: (Up|Down)?(Left|Right)?(Open|Close)
ACTION_NAMES = tuple(
    ud + lr + g for g in ('Open', 'Close') for lr in ('', 'Left', 'Right')
    for ud in ('', 'Up', 'Down'))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, 'tests', 'fixtures', 'torch_jax_demo.pkl.gz')
ENV = 'MoveToRegion-Demo-LoRes4E-v0'


def scripted(obs, t):
    """CLI policy fn(obs, t) -> action index (the reference's table)."""
    return ACTION_NAMES.index('UpOpen' if 4 <= t < 15 else 'RightOpen')


def main():
    env = dict(os.environ, JAX_PLATFORMS='cpu', MAGICAL_TPU_PALLAS='0',
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              'tests')]))
    with tempfile.TemporaryDirectory() as td:
        subprocess.run([sys.executable, '-m', 'magical_tpu', '--env-name',
                        ENV, '--policy', '_torch_tools_fixture:scripted',
                        '--episodes', '1', '--record', td], env=env,
                       check=True, cwd=REPO)
        (path,) = glob.glob(os.path.join(td, '*.pkl.gz'))
        shutil.copy(path, OUT)
    print(OUT, os.path.getsize(OUT), 'bytes')


if __name__ == '__main__':
    main()
