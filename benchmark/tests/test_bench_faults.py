"""A run decides ``correct`` by the comparison with the plain reference:
the sound program passes, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have.
(The cells run on one card: no exchange between cards to leave out.)
Driven on the CPU at small sizes, past the harness's look for a card."""

import pytest
import torch

from benchmark import run
from benchmark.registry import ROOT, Registry
from benchmark.tests.sizes import small

CELLS = ('fleet-odom-outdoor', 'register-b32')


def _guesses(inputs):
    """The poses a registration that does nothing returns: the guesses
    (chained for the fleet)."""
    if len(inputs) == 5:                       # the fleet's inputs
        from laser_slam_tpu_torch.ops import se3
        _, _, _, init, odom = inputs
        poses = [init]
        for t in range(1, odom.shape[1]):
            poses.append(se3.normalize(se3.compose(poses[-1], odom[:, t])))
        return torch.stack(poses, dim=1)
    pts = inputs[0]
    out = torch.zeros((pts.shape[0], 7), dtype=pts.dtype)
    out[:, 0] = 1.0
    return out


def state_unchanged(program):
    return lambda inputs: _guesses(inputs)


def half_the_batch(program):
    """Only the first half of the lanes registered; the others keep their
    guesses."""
    def run_half(inputs):
        poses = program(inputs).clone()
        half = poses.shape[0] // 2
        poses[half:] = _guesses(inputs)[half:]
        return poses
    return run_half


def answer_altered(program):
    """One lane's pose moved by 3 cm where the program returns it."""
    def altered(inputs):
        poses = program(inputs).clone()
        poses[1, ..., 4] += 0.03
        return poses
    return altered


def _run(workload, patch=None, seed=21):
    reg = Registry(ROOT)
    return run.run_cell(reg, workload, seed, 0.3, False, device='cpu',
                        overrides=small(reg, workload), patch=patch)


@pytest.mark.parametrize('workload', CELLS)
def test_the_sound_program_is_correct(workload):
    result = _run(workload)
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] > 0
    assert list(result)[-1] == 'checks'


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('fault', [state_unchanged, half_the_batch,
                                   answer_altered])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    result = _run(workload, patch=fault)
    assert not result['correct'], result['checks']
