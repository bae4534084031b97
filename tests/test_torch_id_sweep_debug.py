"""The ID sweep (tools/id_sweep.py) on a debug-reward ID on the CPU: a
whole episode of MoveToRegion-Demo-DebugReward-LoRes4E-v0 (the shaped
reward, 96² frames) at batch 2, with the sweep's assertions.  The raw
384² frames are tests/test_torch_id_sweep.py's; chip_smoke.py sweeps
every debug-reward ID on the card."""

from magical_tpu_torch.tools import id_sweep


def test_sweep_rolls_a_debug_reward_episode():
    assert id_sweep.run_id('MoveToRegion-Demo-DebugReward-LoRes4E-v0',
                           'cpu') == 40
