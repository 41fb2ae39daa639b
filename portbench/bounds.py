"""The yardstick's table of peaks and the operations and bytes of the
kernels that a roofline share is taken of.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): HBM 3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def adc_bound(q: int, np_: int, s: int, k: int, pmax: int, probed_parts: int) -> dict:
    """The least time of B1's function (the IVF_PQ ADC probe scan) on one
    launch's shapes, whatever implements it: each probed partition's
    codes (S x pmax bytes) and rnorms (4 x pmax) read once, the LUTs
    (Q x S x K f32), the probe ids, q·c and |q|² read once, the (Q, NP,
    pmax) f32 output written once; S LUT adds and a 3-operation epilogue
    per output. Frozen from ``chip_smoke.py`` ``adc_bound``."""
    nbytes = (
        probed_parts * (s * pmax + 4 * pmax) + q * s * k * 4 + q * np_ * 4
        + q * np_ * 4 + q * 4 + q * np_ * pmax * 4
    )
    ops = q * np_ * pmax * (s + 3)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "seconds": max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "ops"}
