"""PyTorch port, kernel K6: the budget model of the CUDA kernels, the route
tuner (K1 or K2a + K2b) and the cuda engine's use of it, on the CPU.

The budget model is held against the kernels' own constants here (parsed
from the CUDA sources) and against ``cudaFuncGetAttributes`` on the card
(``chip_smoke.py``'s build phase). The tuner's timed mode runs here with an
injected runner and timer; on the card it times the kernels themselves.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engines import KernelEngine, KernelMVM, KernelOperator
from repro_torch.kernels import autotune, budget, lk_mvm_op, lk_mvm_ref
from repro_torch.kernels.lk_mvm import MVMLaunch
from repro_torch.kernels.autotune import (autotune_route, cache_contents,
                                          candidate_routes, clear_cache,
                                          heuristic_route)
from repro_torch.kernels.budget import (H100_SXM, INSTANTIATIONS,
                                        DeviceLimits, gram_smem_bytes,
                                        stage_left_smem_bytes,
                                        stream_smem_bytes, tc_smem_bytes)

CSRC = Path(budget.__file__).resolve().parent / "csrc"


def _constants(name: str) -> dict[str, int]:
    """``constexpr int NAME = <integer>;`` of one CUDA source."""
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_cache()
    yield
    clear_cache()


def test_budget_bytes_equal_the_kernels_constants():
    """Every instantiation's shared memory, recomputed from the constants
    the CUDA sources declare: the tensor-core body (K1, K3; 208 and 214
    KB), K2a's ring (110,592 B), K2b's TMA ring (193 or 145 KB) and K4's
    staging rows."""
    tc = _constants("lk_mvm_tc.cuh")
    assert (tc["BM"], tc["BN"], tc["TK"], tc["STAGES"], tc["KR_MAX"]) == (
        256, 128, 32, 2, 64)
    body = (CSRC / "lk_mvm_tc.cuh").read_text()
    assert "LDA = BF16 ? TK + 16 : TK + 8" in body
    assert "LDU_MAX = BF16 ? 80 : 72" in body
    assert "U_FLOATS = BF16 ? 6144 : 5120" in body
    assert "__launch_bounds__(NTHREADS, 1)" in body
    for bf16 in (False, True):
        lda = tc["TK"] + (16 if bf16 else 8)
        ldu = 80 if bf16 else 72
        halves = 1 if bf16 else 2
        stage = tc["BM"] * lda + (6144 if bf16 else 5120) + tc["TK"] * ldu
        want = 4 * (tc["STAGES"] * stage + halves * 64 * ldu
                    + halves * tc["BN"] * lda)
        assert tc_smem_bytes(bf16) == want
    assert (tc_smem_bytes(False), tc_smem_bytes(True)) == (219136, 212992)

    ts = _constants("lk_mvm_two_stage.cu")
    assert (ts["SR"], ts["NTHREADS"], ts["STAGES"]) == (64, 128, 3)
    two = (CSRC / "lk_mvm_two_stage.cu").read_text()
    assert "LDU_MAX = KR_MAX + 8" in two and "LDK = 2 * KR_MAX + 16" in two
    assert "__launch_bounds__(NTHREADS, 2)" in two
    slot = ts["SR"] * (tc["KR_MAX"] + 8)
    assert stream_smem_bytes() == 4 * (ts["STAGES"] * slot + slot
                                       + tc["KR_MAX"] * (2 * tc["KR_MAX"] + 16))
    assert stream_smem_bytes() == 110592
    # the wide kernel (m > 64) launches with the same bytes: its ring of U,
    # mask and K2 chunks fits in them
    assert (ts["KC"], ts["WSTAGES"], ts["NJ"]) == (32, 2, 240)
    assert "LDW = KC + 4" in two and "LDB = NJ + 24" in two
    wide = 4 * ts["WSTAGES"] * (2 * ts["SR"] * (ts["KC"] + 4)
                                + ts["KC"] * (ts["NJ"] + 24))
    assert wide == 104448 <= stream_smem_bytes()

    wg = _constants("lk_mvm_stage_left.cu")
    assert (wg["BM"], wg["BK"], wg["STAGES"], wg["CONSUMERS"]) == (128, 32, 3, 2)
    left = (CSRC / "lk_mvm_stage_left.cu").read_text()
    assert "NTHREADS = 128 * (CONSUMERS + 1)" in left
    assert "__launch_bounds__(NTHREADS, 1)" in left
    assert "BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024" in left
    for bn in (64, 128):
        stage = 2 * wg["BM"] * wg["BK"] * 4 + 2 * bn * wg["BK"] * 4
        assert stage_left_smem_bytes(bn) == wg["STAGES"] * stage \
            + 2 * wg["STAGES"] * 8 + 1024
    assert (stage_left_smem_bytes(128), stage_left_smem_bytes(64)) == (
        197680, 148528)

    g = _constants("rbf_gram.cu")
    assert (g["NTHREADS"], g["RB"], g["DK_SMALL"], g["DK_LARGE"]) == (
        256, 32, 8, 16)
    gram = (CSRC / "rbf_gram.cu").read_text()
    assert "LDS = DK + 4" in gram and "MIN_BLOCKS = V == SMALL ? 3 : 2" in gram
    for dk in (8, 16):
        assert gram_smem_bytes(dk) == 4 * (g["NTHREADS"] // 32) * g["RB"] \
            * (dk + 4)

    for b in INSTANTIATIONS.values():
        want = {"lk_mvm_fused": (512, 1), "lk_mvm_fused_rows": (512, 1),
                "lk_mvm_stage_left": (384, 1), "lk_mvm_two_stage": (128, 2),
                "rbf_gram": (256, 3 if "d<=8" in b.name else 2)}[b.library]
        assert (b.threads, b.min_blocks) == want, b.name


def test_every_instantiation_is_exported_by_its_library():
    """``<library>_attributes(which)`` exists for each library of the model,
    and the model's ``which`` run 0, 1, ... per library."""
    by_lib = {}
    for b in INSTANTIATIONS.values():
        by_lib.setdefault(b.library, []).append(b.which)
    assert set(by_lib) == {"lk_mvm_fused", "lk_mvm_fused_rows",
                           "lk_mvm_two_stage", "lk_mvm_stage_left",
                           "rbf_gram"}
    for lib, whiches in by_lib.items():
        assert sorted(whiches) == list(range(len(whiches)))
        src = (CSRC / f"{lib}.cu").read_text()
        assert f'extern "C" int {lib}_attributes(int which, KernelAttr* out)' \
            in src
    assert len(by_lib["rbf_gram"]) == 12 and len(by_lib["lk_mvm_two_stage"]) == 6
    assert len(by_lib["lk_mvm_stage_left"]) == 2


def test_blocks_per_sm_at_the_h100_limits():
    """One tensor-core block per SM (214 KB), one K2b block (193 KB or 145
    KB of TMA ring), two K2a blocks (255 registers and 110,592 B each),
    three or two K4 blocks (80 or 128 registers)."""
    assert H100_SXM.sms == 132
    for b in INSTANTIATIONS.values():
        want = (1 if b.threads in (512, 384) else 2 if b.threads == 128
                else 3 if "d<=8" in b.name else 2)
        assert b.blocks_per_sm() == want, b.name
        assert b.fits()
    k1 = INSTANTIATIONS["K1 f32 16B"]
    assert k1.reg_cap == 128 and INSTANTIATIONS["K2a 16B full"].reg_cap == 255
    assert INSTANTIATIONS["K4 xf32 outf32 d<=8"].reg_cap == 80
    # Fewer registers than the cap: more K4 blocks (by registers, 4 sub-
    # partitions of 16,384) until shared memory or threads stop them.
    k4 = INSTANTIATIONS["K4 xf32 outf32 d<=8"]
    assert k4.blocks_per_sm(regs=64) == 4 and k4.blocks_per_sm(regs=32) == 8
    # A card that gives a block only 160 KB cannot hold the tensor-core body.
    small = DeviceLimits(sms=100, smem_per_block_optin=160 * 1024,
                         smem_per_sm=164 * 1024)
    assert not k1.fits(small) and k1.blocks_per_sm(small) == 0
    assert INSTANTIATIONS["K2a 16B full"].blocks_per_sm(small) == 1


def test_candidates_and_the_heuristic_route():
    """f32 has both routes, bf16 only the fused kernel (the two-stage
    kernels are float32); the heuristic is the reference's rule, the fused
    kernel when it fits; nothing fits a card without room for the
    tensor-core body, and then it raises."""
    assert candidate_routes("f32") == ["fused", "two_stage"]
    assert candidate_routes("bf16") == ["fused"]
    assert heuristic_route("f32") == heuristic_route("bf16") == "fused"
    small = DeviceLimits(sms=100, smem_per_block_optin=160 * 1024,
                         smem_per_sm=164 * 1024)
    assert candidate_routes("f32", small) == []
    with pytest.raises(RuntimeError, match="no MVM route fits"):
        heuristic_route("f32", small)
    with pytest.raises(ValueError):
        candidate_routes("f16")


def test_cpu_route_is_heuristic_and_cached_per_bucket():
    assert autotune_route(2000, 52, 17, device="cpu") == "fused"
    (key,) = cache_contents()
    assert key == (2048, 64, 32, "f32", "cpu", 132)
    choice = cache_contents()[key]
    assert choice.mode == "heuristic" and choice.times_ms == {}
    # the same bucket: no new entry
    assert autotune_route(1900, 60, 20, device="cpu") == "fused"
    assert len(cache_contents()) == 1
    # other buckets of B, m, n and precision: one entry each
    autotune_route(2000, 52, 1, device="cpu")
    autotune_route(2000, 52, 16, device="cpu")
    autotune_route(2000, 65, 17, device="cpu")
    autotune_route(3000, 52, 17, device="cpu")
    autotune_route(2000, 52, 17, device="cpu", precision="bf16")
    assert len(cache_contents()) == 6
    assert {k[2] for k in cache_contents()} == {1, 16, 32}
    clear_cache()
    assert cache_contents() == {}


def _timed(runner_errs, times, **kw):
    """autotune_route in timed mode on the CPU at a small bucket, the
    runner returning the oracle plus each route's error and the timer each
    route's time (after calling the candidate once, as the real one does)."""
    calls = []

    def runner(route, K1, K2, mask, u, noise):
        calls.append(route)
        return lk_mvm_ref(K1, K2, mask, u, noise) + runner_errs[route]

    def timer(route, fn):
        fn()
        return times[route]

    return autotune_route(20, 5, 3, device="cpu", timed=True, runner=runner,
                          timer=timer, **kw), calls


def test_timed_selection_picks_the_faster_valid_route():
    route, calls = _timed({"fused": 0.0, "two_stage": 0.0},
                          {"fused": 2.0, "two_stage": 1.0})
    assert route == "two_stage"
    (choice,) = cache_contents().values()
    assert choice.mode == "timed" and choice.key[:3] == (32, 8, 4)
    assert choice.times_ms == {"fused": 2.0, "two_stage": 1.0}
    assert all(e <= choice.tol for e in choice.errors.values())
    assert calls.count("fused") == 2 and calls.count("two_stage") == 2
    # cached: the next call in the bucket times nothing
    again, calls = _timed({"fused": 0.0, "two_stage": 0.0},
                          {"fused": 0.5, "two_stage": 1.0})
    assert again == "two_stage" and calls == []
    clear_cache()
    route, _ = _timed({"fused": 0.0, "two_stage": 0.0},
                      {"fused": 0.5, "two_stage": 1.0})
    assert route == "fused"


def test_timed_selection_skips_an_invalid_route():
    route, calls = _timed({"fused": 1.0, "two_stage": 0.0},
                          {"fused": 0.1, "two_stage": 1.0})
    assert route == "two_stage"
    (choice,) = cache_contents().values()
    assert "fused" not in choice.times_ms and choice.errors["fused"] > choice.tol
    assert calls.count("fused") == 1          # checked, never timed


def test_timed_selection_raises_when_every_route_fails():
    with pytest.raises(RuntimeError, match="no MVM route matched"):
        _timed({"fused": 1.0, "two_stage": float("nan")},
               {"fused": 0.1, "two_stage": 0.2})
    assert cache_contents() == {}
    # bf16 has one candidate; when it misses, nothing is left
    with pytest.raises(RuntimeError, match="no MVM route matched"):
        _timed({"fused": 10.0}, {"fused": 0.1}, precision="bf16")


def _operator_inputs(seed=3, n=12, m=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    K1 = A @ A.T / n + 0.5 * np.eye(n)
    C = rng.standard_normal((m, m))
    K2 = C @ C.T / m + 0.5 * np.eye(m)
    mask = (rng.uniform(size=(n, m)) < 0.8).astype(np.float64)
    return [torch.tensor(a) for a in (K1, K2, mask)], torch.tensor(0.2,
                                                                   dtype=torch.float64)


def test_route_resolved_once_per_operator_forward_and_backward_alike(
        monkeypatch):
    """A routed KernelOperator asks the tuner once per batch bucket, keeps
    the answer, and the forward sweep and the backward's ``du`` sweep run
    the same route, whatever the tuner says later."""
    asked, swept = [], []
    answers = iter(["two_stage", "fused", "fused", "fused"])

    def fake_route(n, m, B, *, precision, device):
        asked.append((n, m, B, precision, str(device)))
        return next(answers)

    real_sweep = MVMLaunch.__call__

    def spy_sweep(launch, u):
        swept.append((tuple(u.shape), launch.route == "fused"))
        return real_sweep(launch, u)

    monkeypatch.setattr(autotune, "autotune_route", fake_route)
    monkeypatch.setattr(MVMLaunch, "__call__", spy_sweep)
    (K1, K2, mask), noise = _operator_inputs()
    A = KernelEngine().operator_from_grams(K1, K2, mask, noise)
    assert isinstance(A, KernelOperator) and A.fused is None
    u = torch.randn((3, 12, 5), dtype=torch.float64, requires_grad=True)
    out = A(u)
    out.sum().backward()
    A(u.detach() * 2)                      # same bucket: no new question
    A(torch.randn((4, 12, 5), dtype=torch.float64))   # B = 4: bucket 4 again
    assert asked == [(12, 5, 3, "f32", "cpu")]
    assert A.routes == {4: False}
    assert swept == [((3, 12, 5), False)] * 3 + [((4, 12, 5), False)]
    A(torch.randn((12, 5), dtype=torch.float64))      # B = 1: a new bucket
    assert A.routes == {4: False, 1: True} and len(asked) == 2
    # a second operator asks again (and gets the tuner's answer of now)
    B_op = KernelEngine().operator_from_grams(K1, K2, mask, noise)
    B_op(u.detach())
    assert B_op.routes == {4: True} and len(asked) == 3


def test_routed_operator_matches_the_oracle_on_the_cpu():
    """Routed on the CPU (heuristic: the fused kernel's plain version), the
    operator and its gradient agree with the float64 oracle to float32
    rounding, and a named route is obeyed without asking the tuner."""
    (K1, K2, mask), noise = _operator_inputs(seed=4)
    u = torch.randn((2, 12, 5), dtype=torch.float64)
    want = lk_mvm_ref(K1, K2, mask, u, noise)
    for fused in (None, True, False):
        A = KernelMVM(fused=fused).operator(K1, K2, mask, noise)
        got = A(u)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert A.routes == ({1 << 1: True} if fused is None else {})
    assert cache_contents() and all(
        c.mode == "heuristic" for c in cache_contents().values())


def test_lk_mvm_op_asks_the_tuner_only_without_a_named_route(monkeypatch):
    asked = []
    monkeypatch.setattr(
        "repro_torch.kernels.ops.autotune_route",
        lambda n, m, B, **kw: asked.append((n, m, B)) or "two_stage")
    (K1, K2, mask), noise = _operator_inputs(seed=5)
    f32 = [x.float() for x in (K1, K2, mask)]
    u = torch.randn((2, 3, 12, 5))
    want = lk_mvm_ref(*f32, u, float(noise))
    got = lk_mvm_op(*f32, u, float(noise), force_kernel=True, device="cpu")
    assert asked == [(12, 5, 6)]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    lk_mvm_op(*f32, u, float(noise), force_kernel=True, device="cpu",
              fused=True)
    lk_mvm_op(*f32, u, float(noise), device="cpu")          # the oracle
    assert asked == [(12, 5, 6)]
