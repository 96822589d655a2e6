"""Device roofline peaks — the port of the peak table of
``janusgraph_tpu/observability/profiler.py`` (``_DEVICE_PEAKS``,
``configure_roofline``, ``device_peaks``).

The autotuner prices its layouts against these peaks. The reference's TPU
and CPU rows are kept as they are, so decisions for those kinds stay equal
to the reference's; the port adds a row for the H100.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: (device_kind substring, peak flops/s, peak memory bytes/s, peak matrix
#: flops/s). First match wins, on the lower-cased kind.
_DEVICE_PEAKS: Tuple[Tuple[str, float, float, float], ...] = (
    # NVIDIA H100 SXM (torch.cuda.get_device_name: "NVIDIA H100 80GB HBM3"),
    # data-sheet peaks at its 700 W limit: fp32 outside the tensor cores,
    # HBM3, and dense TF32 on the tensor cores as the matrix peak
    ("h100", 67e12, 3.35e12, 494.7e12),
    ("v5e", 197e12, 819e9, 197e12),
    ("v5p", 459e12, 2765e9, 459e12),
    ("v4", 275e12, 1228e9, 275e12),
    ("v3", 123e12, 900e9, 123e12),
    ("v2", 45e12, 700e9, 45e12),
    # CPU fallback: a generous server-class core count; what matters on the
    # CPU is the relative shape of the model, not its absolute truth
    ("cpu", 5e11, 5e10, 1e11),
)

#: rows that describe a GPU: the autotuner prices them with its "gpu"
#: constants
GPU_ROWS = ("h100",)

_ROOFLINE_OVERRIDE = {
    "peak_flops": 0.0, "peak_bytes_per_s": 0.0, "peak_mxu_flops": 0.0,
}


def configure_roofline(
    peak_flops: Optional[float] = None,
    peak_bytes_per_s: Optional[float] = None,
    peak_mxu_flops: Optional[float] = None,
) -> None:
    """Operator override of the peak table (0 = the table's row)."""
    if peak_flops is not None:
        _ROOFLINE_OVERRIDE["peak_flops"] = float(peak_flops)
    if peak_bytes_per_s is not None:
        _ROOFLINE_OVERRIDE["peak_bytes_per_s"] = float(peak_bytes_per_s)
    if peak_mxu_flops is not None:
        _ROOFLINE_OVERRIDE["peak_mxu_flops"] = float(peak_mxu_flops)


def current_device_kind() -> str:
    """The name of CUDA device 0, or "cpu" without one."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def device_peaks(device_kind: Optional[str] = None) -> dict:
    """{peak_flops, peak_bytes_per_s, peak_mxu_flops, device_kind, source}
    for the named device kind, or for the current device (asked of torch)."""
    if device_kind is None:
        device_kind = current_device_kind()
    kind = (device_kind or "cpu").lower()
    flops, bw, mxu, source = 0.0, 0.0, 0.0, "default"
    for sub, pf, pb, pm in _DEVICE_PEAKS:
        if sub in kind:
            flops, bw, mxu, source = pf, pb, pm, f"table:{sub}"
            break
    if not flops:
        flops, bw, mxu = (
            _DEVICE_PEAKS[-1][1], _DEVICE_PEAKS[-1][2], _DEVICE_PEAKS[-1][3]
        )
    if _ROOFLINE_OVERRIDE["peak_flops"]:
        flops, source = _ROOFLINE_OVERRIDE["peak_flops"], "config"
    if _ROOFLINE_OVERRIDE["peak_bytes_per_s"]:
        bw = _ROOFLINE_OVERRIDE["peak_bytes_per_s"]
        source = "config"
    if _ROOFLINE_OVERRIDE["peak_mxu_flops"]:
        mxu = _ROOFLINE_OVERRIDE["peak_mxu_flops"]
        source = "config"
    return {
        "peak_flops": flops,
        "peak_bytes_per_s": bw,
        "peak_mxu_flops": mxu,
        "device_kind": device_kind,
        "source": source,
    }
