"""What `chip_smoke.py` reads its reports from, fed here by hand: no
compiler, no card.

`_build.ptxas_report` keeps a kernel's entry lines (stack, spills,
registers) and any other line naming it, the C75xx advisories that
ptxas serialised its ``wgmma``s among them; `chip_smoke.ptxas_numbers`
turns them into numbers by template argument (by head dim and ``kLse``
for the Hopper flash forward), and `chip_smoke.ptxas_gate` fails on a
spill or an advisory, the flash backward's two Hopper kernels each at its
four head dims. `chip_smoke.
profile_train_step` sums the profiler's device operations (kineto's
events, the host's left out): busy time, the costliest names, and the
port's kernels by name wherever they rank;
`chip_smoke.bwd_pairs` counts the (row, key) pairs of a causal mask with
a prefix or a sliding window and the 64 x 64 blocks the backward kernels
multiply.
"""
from __future__ import annotations

import pathlib
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TGMM_F = "_ZN12_GLOBAL__N_113gmm_bf16_tgmmIfEEv14CUtensorMap_stS1_PKiPT_iiii"
TGMM_H = ("_ZN12_GLOBAL__N_113gmm_bf16_tgmmI13__nv_bfloat16EEv14CUtensorMap"
          "_stS2_PKiPT_iiii")
WGMMA = ("_ZN12_GLOBAL__N_114gmm_bf16_wgmmaIfLb0EEEv14CUtensorMap_stS1_"
         "PKiPT_iiiii")


def _entry(name, regs, spills):
    return [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    0 bytes stack frame, {spills} bytes spill stores, "
            f"{spills} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers"]


LOG = "\n".join([
    *_entry(WGMMA, 168, 0),
    f"ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
    f"instructions are serialized in the function '{TGMM_H}'",
    *_entry(TGMM_F, 168, 0),
    *_entry(TGMM_H, 170, 8),
    f"ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
    f"instructions are serialized in the function '{WGMMA}'",
])


@pytest.fixture
def log(tmp_path, monkeypatch):
    lib = tmp_path / "moe_gmm-0.so"
    lib.with_suffix(".log").write_text(LOG)
    monkeypatch.setattr(_build, "library_path", lambda name: lib)


def test_ptxas_report_keeps_a_kernels_lines_and_advisories(log):
    lines = _build.ptxas_report("moe_gmm", "gmm_bf16_tgmm")
    assert len(lines) == 9
    assert all("wgmma" not in ln or "tgmm" in ln for ln in lines)
    assert sum("(C7512)" in ln for ln in lines) == 1
    assert _build.ptxas_report("moe_gmm", "no_such_kernel") == []


def test_ptxas_numbers_by_instantiation(log):
    got = chip_smoke.ptxas_numbers("moe_gmm", "gmm_bf16_tgmm",
                                   chip_smoke.TGMM_PTXAS_KEY)
    assert set(got) == {"f", "13__nv_bfloat16"}
    assert got["f"] == {"serialized": [], "stack": 0, "spill_stores": 0,
                        "spill_loads": 0, "registers": 168}
    half = got["13__nv_bfloat16"]
    assert (half["registers"], half["spill_stores"]) == (170, 8)
    assert len(half["serialized"]) == 1 and TGMM_H in half["serialized"][0]


def _flash_fwd(d, lse):
    return (f"_ZN12_GLOBAL__N_120flash_fwd_bf16_wgmmaILi{d}ELb{lse}EEEv14"
            f"CUtensorMap_stS1_S1_P13__nv_bfloat16PfiiNS_4MaskEfi")


@pytest.fixture
def flash_log(tmp_path, monkeypatch):
    """A flash_attn build log: every (head dim, kLse) of the Hopper forward
    with 168 registers and no spill, but <256, true> with 8 bytes of
    spills and a C7512 line, and one backward kernel beside them."""
    lines = [*_entry("_ZN12_GLOBAL__N_118flash_bwd_dq_wgmmaILi64EEEv14CUtensor"
                     "Map_st", 168, 0)]
    for d in (64, 80, 128, 256):
        for lse in (0, 1):
            lines += _entry(_flash_fwd(d, lse), 168, 8 * (d == 256 and lse))
    lines.append(f"ptxas info    : (C7512) Potential Performance Loss: "
                 f"wgmma.mma_async instructions are serialized in the "
                 f"function '{_flash_fwd(256, 1)}'")
    lib = tmp_path / "flash_attn-0.so"
    lib.with_suffix(".log").write_text("\n".join(lines))
    monkeypatch.setattr(_build, "library_path", lambda name: lib)


def test_flash_forward_ptxas_by_head_dim_and_lse(flash_log):
    """The Hopper forward's eight instantiations are told apart by head
    dim and kLse (the default key, by head dim alone, would merge each
    pair), and `ptxas_gate` fails on the one that spills and serialises,
    or on a set of instances that is not the one asked for."""
    got = chip_smoke.ptxas_numbers("flash_attn", "flash_fwd_bf16_wgmma",
                                   chip_smoke.FLASH_FWD_PTXAS_KEY)
    assert set(got) == chip_smoke.FLASH_FWD_INSTANCES
    assert got["256,0"] == {"serialized": [], "stack": 0, "spill_stores": 0,
                            "spill_loads": 0, "registers": 168}
    assert got["256,1"]["spill_stores"] == 8
    assert len(got["256,1"]["serialized"]) == 1
    with pytest.raises(AssertionError, match="flash_fwd_bf16_wgmma"):
        chip_smoke.ptxas_gate("flash_attn", "flash_fwd_bf16_wgmma",
                              chip_smoke.FLASH_FWD_PTXAS_KEY,
                              chip_smoke.FLASH_FWD_INSTANCES)
    clean = chip_smoke.FLASH_FWD_INSTANCES - {"256,1"}
    with pytest.raises(AssertionError, match="no report"):
        chip_smoke.ptxas_gate("flash_attn", "flash_fwd_bf16_wgmma",
                              chip_smoke.FLASH_FWD_PTXAS_KEY, clean)
    assert chip_smoke.ptxas_gate("flash_attn", "flash_fwd_bf16_wgmma",
                                 r"wgmmaILi(\d+)ELb0E",
                                 {"64", "80", "128", "256"})["256"] == got[
                                     "256,0"]


def _flash_bwd(kernel, d):
    return (f"_ZN46_GLOBAL__N__72ef4e4e_13_flash_attn_cu_148ca421"
            f"{len(kernel)}{kernel}ILi{d}EEEv14CUtensorMap_stS1_S1_S1_PKfPfPi"
            f"P13__nv_bfloat16S7_iiNS_4MaskEfi")


@pytest.mark.parametrize("spill", [0, 24])
def test_flash_backward_ptxas_gate_by_head_dim(tmp_path, monkeypatch, spill):
    """Both Hopper backward kernels are gated at head dims 64, 80, 128 and
    256, each apart from the other: a spill in the d 256 dq kernel (24
    bytes, as a 128-row dq block at d 256 spilled) fails the dq gate and
    leaves the dk/dv one passing."""
    lines = []
    for d in (64, 80, 128, 256):
        for kernel in chip_smoke.FLASH_BWD_KERNELS:
            lines += _entry(_flash_bwd(kernel, d), 168,
                            spill * (d == 256 and "dq" in kernel))
    lib = tmp_path / "flash_attn-0.so"
    lib.with_suffix(".log").write_text("\n".join(lines))
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    dq, dkdv = chip_smoke.FLASH_BWD_KERNELS
    got = chip_smoke.ptxas_gate("flash_attn", dkdv, r"ILi(\d+)E",
                                chip_smoke.FLASH_BWD_INSTANCES)
    assert set(got) == chip_smoke.FLASH_BWD_INSTANCES == {"64", "80", "128",
                                                          "256"}
    if spill:
        with pytest.raises(AssertionError, match=dq):
            chip_smoke.ptxas_gate("flash_attn", dq, r"ILi(\d+)E",
                                  chip_smoke.FLASH_BWD_INSTANCES)
    else:
        assert chip_smoke.ptxas_gate("flash_attn", dq, r"ILi(\d+)E",
                                     chip_smoke.FLASH_BWD_INSTANCES) == got


@pytest.mark.parametrize("s,prefix", [(300, 100), (200, 0), (64, 0),
                                      (130, 400), (4096, 256)])
def test_bwd_pairs_counts_what_the_kernels_multiply(s, prefix):
    """`chip_smoke.bwd_pairs` against a count over the mask itself: the
    pairs a causal mask with a prefix lets through, and the 64 x 64
    blocks holding one or more of them (those the backward kernels
    multiply)."""
    import torch
    from repro_torch.kernels.flash_attn.ref import visible
    pos = torch.arange(s)
    seen = visible(pos, pos, prefix=prefix)
    n = -(-s // 64)
    blocks = torch.zeros(n * 64, n * 64, dtype=torch.bool)
    blocks[:s, :s] = seen
    held = blocks.reshape(n, 64, n, 64).any(3).any(1)
    assert chip_smoke.bwd_pairs(s, prefix) == (int(seen.sum()),
                                               int(held.sum()))


@pytest.mark.parametrize("s,prefix,window", [(300, 0, 100), (200, 0, 64),
                                             (200, 0, 65), (300, 100, 48),
                                             (130, 0, 4096),
                                             (1000, 0, 256)])
def test_bwd_pairs_counts_a_window(s, prefix, window):
    """`chip_smoke.bwd_pairs` with a sliding window, against the same
    count over the mask itself: windows that end on a block's edge and
    one past it, a window over a prefix, and one longer than S (it cuts
    nothing: the causal count)."""
    import torch
    from repro_torch.kernels.flash_attn.ref import visible
    pos = torch.arange(s)
    seen = visible(pos, pos, prefix=prefix, window=window)
    n = -(-s // 64)
    blocks = torch.zeros(n * 64, n * 64, dtype=torch.bool)
    blocks[:s, :s] = seen
    held = blocks.reshape(n, 64, n, 64).any(3).any(1)
    assert chip_smoke.bwd_pairs(s, prefix, window) == (int(seen.sum()),
                                                       int(held.sum()))
    if window >= s and not prefix:
        assert chip_smoke.bwd_pairs(s, prefix, window) == \
            chip_smoke.bwd_pairs(s)


class _Op:
    """A kineto event as ``profile.profiler.kineto_results.events()``
    gives it: times in ns."""

    def __init__(self, name, start, end, device="CUDA"):
        self._name, self._start, self._end = name, start * 1000, end * 1000
        self._device = device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        from torch.autograd import DeviceType
        return getattr(DeviceType, self._device)


def test_profile_names_the_ports_kernels(monkeypatch):
    import torch
    ops = [_Op("void (anonymous namespace)::gmm_bf16_tgmm<__nv_bfloat16>"
               "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, int)", 0,
               500),
           _Op("nvjet_hsh_256x128_64x4_2x1_v_bz_coopA_NTN", 400, 2400),
           _Op("void (anonymous namespace)::gmm_bf16_tgmm<float>(...)",
               3000, 3400),
           _Op("void (anonymous namespace)::flash_bwd_dq_wgmma<64>(...)",
               3500, 3600),
           _Op("aten::mm", 0, 5000, device="CPU")]

    class Profile:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return ops

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Profile())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out = chip_smoke.profile_train_step(
        lambda m, o, b: (m, o, {"loss": torch.tensor(1.0)}), None, None,
        None, 1.0)
    assert out["busy_s"] == pytest.approx(2900e-6)
    assert out["device_ops"] == 4
    assert out["top"][0]["ms"] == pytest.approx(2.0)
    assert out["port_kernels"] == {
        "gmm_bf16_tgmm": {"ms": pytest.approx(0.9), "launches": 2},
        "flash_bwd_dq_wgmma": {"ms": pytest.approx(0.1), "launches": 1}}
