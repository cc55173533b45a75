"""``chip_smoke.py`` on the CPU: its phase functions at B=16 (and its
four-device phases on the virtual mesh) with their own gates, its refusal to
run anywhere but a GPU, and ``__graft_entry__.dryrun_multichip``."""

import jax
import numpy as np
import pytest

import __graft_entry__ as ge
import chip_smoke


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    err = capsys.readouterr()
    assert "needs a GPU" in err.err and "'cpu'" in err.err
    assert err.out == ""


@pytest.mark.parametrize("method", ["ADAMS", "BDF"])
def test_phase_lv_adjoint(method):
    r = chip_smoke.phase_lv_adjoint(batch=16, method=method, card="cpu")
    assert r["worst_rel_err"] < 2e-3
    assert r["gy"].shape == (16, 2) and r["gp"].shape == (16, 2)
    if method == "ADAMS":
        assert r["fwd_attempts"] >= r["fwd_steps_max"] > 0
        assert r["bwd_steps_max"] > 0


def test_phase_robertson():
    assert chip_smoke.phase_robertson(batch=16, card="cpu")["worst_gate_ratio"] <= 1.0


def test_phase_lv_adjoint_f32():
    assert chip_smoke.phase_lv_adjoint_f32(batch=16, card="cpu")["worst_rel_err"] < 1e-2


def test_phase_sympy_matches_jax_problem():
    pytest.importorskip("sympy")
    ref = chip_smoke.phase_lv_adjoint(batch=16, card="cpu")
    assert chip_smoke.phase_sympy(ref["gy"], ref["gp"], card="cpu") < 1e-7


def test_phase_chain_sharding_on_virtual_devices():
    assert chip_smoke.phase_chain_sharding(batch=32, n_devices=4, card="cpu") < 1e-7


def test_phase_state_sharding_on_virtual_devices():
    assert chip_smoke.phase_state_sharding(regions=16, batch=4, card="cpu") < 1e-10


def test_dryrun_multichip_raises_with_too_few_devices():
    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices, found {n - 1}"):
        ge.dryrun_multichip(n)


def test_dryrun_multichip_on_four_virtual_devices(capsys):
    ge.dryrun_multichip(4)
    assert "dryrun_multichip OK: 4 devices" in capsys.readouterr().out


def test_lv_problem_front_ends_agree():
    pytest.importorskip("sympy")
    y = np.array([10.0, 2.0])
    p = np.array([1.0, 0.3, 1.0, 0.4])
    f_jax = ge.lv_problem().make_rhs()(0.0, y, p)
    f_sym = ge.lv_problem(symbolic=True).make_rhs()(0.0, y, p)
    np.testing.assert_allclose(np.asarray(f_jax), np.asarray(f_sym), rtol=1e-15)
