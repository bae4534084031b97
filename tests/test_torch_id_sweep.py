"""A sample of magical_tpu_torch's ID sweep (tools/id_sweep.py) on the CPU:
whole episodes of random actions, with the assertions of
scripts/run_id_sweep.py, of MoveToRegion-Demo raw (384² {allo, ego}, at
batch 1: the plain render of its frames takes most of the time) and with
two preprocessors at the sweep's batch 2 (tests/test_torch_id_sweep_debug.py
takes a debug-reward ID); and the sweep's ledger (resume, failures
recorded).  On the card chip_smoke.py sweeps all 366 at batch 2."""

import os

import pytest

from magical_tpu_torch.tools import id_sweep


# batch 1 for the raw ID
BATCH = {'MoveToRegion-Demo-v0': 1}


@pytest.mark.parametrize('name', ['MoveToRegion-Demo-v0',
                                  'MoveToRegion-Demo-LoRes4E-v0',
                                  'MoveToRegion-Demo-LoRes4A-v0'])
def test_sweep_rolls_a_whole_episode(name):
    assert id_sweep.run_id(name, 'cpu',
                           batch=BATCH.get(name, id_sweep.BATCH)) == 40


def test_sweep_ledger_resumes_and_records_failures(tmp_path, capsys):
    ledger = str(tmp_path / 'sub' / 'sweep.txt')
    os.makedirs(os.path.dirname(ledger))
    with open(ledger, 'w') as f:
        f.write('MoveToRegion-Demo-v0 ok\n'
                'MoveToRegion-Demo-LoRes4E-v0 FAIL AssertionError: x\n')
    ids = ['MoveToRegion-Demo-v0', 'NoSuchTask-Demo-v0']
    out = id_sweep.main(['--ledger', ledger, '--device', 'cpu', '--ids',
                         *ids])
    assert out['green'] == 1 and out['total'] == 2
    assert out['failed'] == ['NoSuchTask-Demo-v0'] and out['steps'] == 0
    assert id_sweep.load_ledger(ledger) == {'MoveToRegion-Demo-v0'}
    lines = open(ledger).read().splitlines()
    assert lines[-1].startswith('NoSuchTask-Demo-v0 FAIL ')
    assert '1 already green, 1 this process of 2 total' in \
        capsys.readouterr().out
    # --max-ids 0 runs nothing, --reverse walks from the other end
    out = id_sweep.main(['--ledger', ledger, '--device', 'cpu', '--ids',
                         *ids, '--max-ids', '0', '--reverse'])
    assert out['failed'] == [] and out['green'] == 1
