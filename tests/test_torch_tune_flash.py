"""``repro_torch.launch.tune_flash`` on the CPU: its TF32 rounding (the
probe's "exact in TF32" operands) rounds as ``cvt.rna.tf32.f32`` does, and
the split-TF32 variant it builds keeps the f32 kernel's C entry (a build
without it would fail only on the card, after nvcc)."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import tune_flash  # noqa: E402

VARIANT = (Path(tune_flash.build.__file__).resolve().parent
           / "flash_attention" / "variants" / "flash_attention_tf32.cu")


def test_tf32_rounds_to_nearest_ties_away_keeping_10_mantissa_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=100_000).astype(np.float32) * 7)
    y = tune_flash.tf32(x)
    bits = y.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())          # 13 low bits clear
    # within half a TF32 ulp (2**-11 relative to the binade), never more
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 11)
    assert bool(((x - y).abs() <= ulp / 2).all())
    # exact TF32 values pass unchanged; a tie rounds away from zero
    assert torch.equal(tune_flash.tf32(y), y)
    one = torch.tensor([1.0], dtype=torch.float32)
    tie = (one.view(torch.int32) | 0x1000).view(torch.float32)  # 1 + 2**-11
    assert float(tune_flash.tf32(tie)) == 1.0 + 2.0 ** -10
    assert float(tune_flash.tf32(-tie)) == -(1.0 + 2.0 ** -10)


def test_variant_keeps_the_f32_entry():
    text = VARIANT.read_text()
    assert re.search(r'extern "C" int flash_attention_fwd\(void\* out, '
                     r'const void\* q, const void\* k,\s+const void\* v, '
                     r'int b, int s, int h,\s+int kh, int dh, int window, '
                     r'float softcap,\s+float scale, void\* stream\)', text)
