"""The comparison that decides ``correct``: it passes on the program as it
stands, and comes out false when the timed path is broken underneath (the
step returns its state unchanged; half of the batch left out, its answers
copied from the other half; an answer altered where it is produced; a
registration that is wrong but carried through consistently: too few ICP
iterations, a feature class's rows left out, the motion prior returned as
the answer) and for the control (the reference's step in TF32 in the
program's place).  CPU, the tiny cell; everything but the look for a card
is a run's."""

import pytest
import torch

import benchutil
import readings
from benchlib import check
from mulls_tpu_torch.parallel import multiseq
from mulls_tpu_torch.pipeline import odometry

REAL_STEP = multiseq.slam_step
REAL_ICP = odometry.mm_lls_icp


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unchanged(state, raw, cfg, frame=None):
    _, out = REAL_STEP(state, raw, cfg, frame=frame)
    return state, out


def _half_left_out(state, raw, cfg, frame=None):
    from mulls_tpu_torch.core.tree import tree_map
    new, out = REAL_STEP(state, raw, cfg, frame=frame)
    h = out.vec.shape[0] // 2
    kept = tree_map(lambda n, o: torch.cat([n[:h], o[h:]]),
                    new.replace(draws=None), state.replace(draws=None))
    vec = out.vec.clone()
    vec[h:] = vec[:h][:vec.shape[0] - h]
    return kept.replace(draws=new.draws), out.replace(vec=vec)


def _answer_altered(state, raw, cfg, frame=None):
    new, out = REAL_STEP(state, raw, cfg, frame=frame)
    vec = out.vec.clone()
    vec[..., 3] += 0.1  # T_rel's x translation, 10 cm
    return new, out.replace(vec=vec)


def _icp_few_iterations(source, target, cfg, guess, max_iter, **kw):
    return REAL_ICP(source, target, cfg, guess, 2, **kw)


def _icp_without_facades(source, target, cfg, guess, max_iter, **kw):
    import dataclasses
    bits = list(cfg.used_feature_type)
    bits[2] = "0"  # facade
    return REAL_ICP(source, target, dataclasses.replace(
        cfg, used_feature_type="".join(bits)), guess, max_iter, **kw)


def _icp_returns_prior(source, target, cfg, guess, max_iter, **kw):
    res = REAL_ICP(source, target, cfg, guess, max_iter, **kw)
    return res.replace(transform=guess.clone())


def test_the_program_as_it_stands_passes(tmp_path, capsys):
    root, here = benchutil.tiny_root(tmp_path)
    for seed in (9, 2**31 + 13):
        res = benchutil.run_tiny(root, here, seed, capsys=capsys)
        assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_batch_left_out",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, capsys, monkeypatch,
                                            fault):
    monkeypatch.setattr(multiseq, "slam_step", fault)
    root, here = benchutil.tiny_root(tmp_path)
    res = benchutil.run_tiny(root, here, 21, capsys=capsys)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", [_icp_few_iterations,
                                   _icp_without_facades,
                                   _icp_returns_prior],
                         ids=["icp_two_iterations", "icp_without_facades",
                              "icp_returns_prior"])
def test_a_consistent_registration_fault_is_not_correct(
        tmp_path, capsys, monkeypatch, fault):
    monkeypatch.setattr(odometry, "mm_lls_icp", fault)
    root, here = benchutil.tiny_root(tmp_path)
    res = benchutil.run_tiny(root, here, 21, capsys=capsys)
    assert res["correct"] is False, res["checks"]
    assert any(res["checks"][n]["value"] > res["checks"][n]["limit"]
               for n in ("reg_miss", "reg_code_miss")), res["checks"]


def test_a_perturbed_answer_fails_its_number():
    names = ("nn_miss", "pca_gap", "feat_miss", "reg_miss", "map_miss",
             "carry_gap_m")
    limits = {name: {"limit": 0.01} for name in names}
    limits["map_match_m"] = 0.001
    numbers = dict.fromkeys(names, 0.0)
    assert check.judge(numbers, limits)[0] is True
    for name in names:
        bad = dict(numbers, **{name: 0.02})
        ok, checks = check.judge(bad, limits)
        assert ok is False and checks[name]["value"] == 0.02
    assert check.judge({k: v for k, v in numbers.items()
                        if k != "carry_gap_m"}, limits)[0] is False


def test_the_control_fails_the_limits(tmp_path):
    root, here = benchutil.tiny_root(tmp_path)
    from benchlib.catalog import Catalog
    cat = Catalog(root, here)
    limits = cat.limits("tiny_fleet")
    nums, _ = readings.control_numbers(cat, benchutil.TINY_CELL, 5,
                                       torch.device("cpu"))
    assert check.judge(nums, limits)[0] is False, nums
