"""Holding two runs of a round on a lossy wire to each other.

Two correct runs of one round — the port against the reference, or the
card against the CPU — train to parameters that differ by about 1e-6
(other convolution and GroupNorm arithmetic).  On a lossy wire such a
difference now and then flips a rounding: an int8 or bf16 round to
nearest, a stochastic floor, or a top-k membership, which also shifts the
compacted positions behind it, and so their scale groups and random bits.
The element then moves by about one quantization step, far beyond any
float tolerance.  So a lossy round is held to two rules
(:func:`lossy_compare`):

1. the share of elements outside ``rtol``/``atol`` is at most a stated
   small fraction;
2. every element is within ``atol + rtol |b| + step``, where ``step`` is
   what one flip can move it by: the broadcast's step at that element (its
   int8 group's scale, or a bf16 ulp) plus the largest step any client's
   upload has there (its scale group's step where the element was kept,
   and under top-k also the client's smallest kept magnitude, the most a
   membership flip moves an element).

Dense uploads are the trained models themselves, whose step lies between
the broadcast's and the new server model's (:func:`round_step`).  Delta
uploads are recorded as the round encodes them:
:class:`UploadSteps` wraps the trainer's per-client encoder.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

from repro_torch.core import comm, federated


def wire_step(spec: comm.WireSpec, flat: torch.Tensor) -> torch.Tensor:
    """Per-element quantization step of encoding ``flat`` (``(n,)``) on
    ``spec``'s wire: its int8 group's scale, a bf16 ulp, or 0 on f32."""
    flat = flat.to(torch.float32)
    if spec.is_quantized:
        buf = comm.encode(comm.WireSpec("int8", spec.quant_block), flat)
        return torch.repeat_interleave(buf.scales, spec.quant_block)[
            :flat.shape[0]]
    if spec.dtype == "bfloat16":
        exp = torch.frexp(flat.abs()).exponent.to(torch.float32)
        return torch.where(flat == 0, 0.0, torch.exp2(exp - 8.0))
    return torch.zeros_like(flat)


class UploadSteps:
    """Elementwise max, over every delta upload encoded while it is
    active, of the step that upload can move an element by.  Use as a
    context manager around ``run_round``; ``step`` is ``None`` until a
    delta upload was encoded."""

    def __init__(self):
        self.step: Optional[torch.Tensor] = None

    def _record(self, up, d: torch.Tensor, buf) -> None:
        spec = up.spec
        if spec.is_sparse:
            vals = comm.sparse_decode_values(spec, buf)
            kept = wire_step(spec, vals) if not spec.is_quantized else \
                torch.repeat_interleave(buf.scales, spec.quant_block)
            step = torch.zeros_like(d, dtype=torch.float32)
            step[buf.indices.to(torch.int64)] = kept.to(torch.float32)
            step = step + vals.abs().min()
        else:
            step = wire_step(spec, comm.decode(spec, buf))
        step = step.cpu()
        self.step = step if self.step is None else torch.maximum(self.step,
                                                                 step)

    @contextlib.contextmanager
    def __call__(self) -> Iterator["UploadSteps"]:
        inner = federated._encode_upload

        def encode_and_record(up, d, bits):
            buf = inner(up, d, bits)
            self._record(up, d, buf)
            return buf

        federated._encode_upload = encode_and_record
        try:
            yield self
        finally:
            federated._encode_upload = inner


def outside(a: torch.Tensor, b: torch.Tensor, *, rtol: float = 1e-4,
            atol: float = 1e-5) -> torch.Tensor:
    """Elementwise: ``a`` lies outside ``atol + rtol |b|`` of ``b`` (the
    elements rule 1 counts, on the CPU in f32)."""
    a, b = (t.detach().to("cpu", torch.float32) for t in (a, b))
    return ~((a - b).abs() <= atol + rtol * b.abs())


def lossy_compare(a: torch.Tensor, b: torch.Tensor, step: torch.Tensor, *,
                  rtol: float = 1e-4, atol: float = 1e-5) -> Dict[str, float]:
    """Compare two flat vectors under the lossy-wire rules: ``share`` is
    the fraction of elements outside ``atol + rtol |b|`` (rule 1), and
    ``worst`` the largest ``(|a - b| - tol) / step`` over the elements
    outside the tolerance (rule 2 holds when it is at most 1; ``inf``
    where such an element has no step)."""
    a, b, step = (t.detach().to("cpu", torch.float32) for t in (a, b, step))
    diff = (a - b).abs()
    tol = atol + rtol * b.abs()
    out = outside(a, b, rtol=rtol, atol=atol)
    excess = (diff - tol)[out]
    ratio = excess / step[out]
    return {"share": float(out.float().mean()), "n_out": int(out.sum()),
            "worst": float(ratio.max()) if ratio.numel() else 0.0,
            "max_abs": float(diff.max())}


def round_step(spec: comm.WireSpec, start: torch.Tensor, end: torch.Tensor,
               uploads: UploadSteps) -> torch.Tensor:
    """The per-element step bound of rule 2 for one round that went from
    the flat server vector ``start`` to ``end``: one broadcast step (of
    ``start``), plus one upload step — the recorded delta uploads' step,
    or for dense uploads the larger of the two vectors' steps (a trained
    model lies between them)."""
    bcast = wire_step(spec, start).cpu()
    if not spec.uses_deltas:
        return bcast + torch.maximum(bcast, wire_step(spec, end).cpu())
    if uploads.step is None:
        return bcast
    return bcast + uploads.step
