"""Roofline analysis of the dry run's records, for an NVIDIA H100 SXM
(torch counterpart of ``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds a step on one card:

  compute    = sum over dtypes of the step's FLOPs in that dtype / the
               card's dense peak for it
  memory     = the geometric midpoint of ``bytes`` (every op's operands
               and outputs: no fusion) and ``bytes_min`` (the step's
               arguments and results once: perfect fusion) / HBM bandwidth
  collective = wire bytes of the collectives / NVLink bandwidth (the
               ring estimate treats a rank's links in series)

The records are per rank (``launch/dryrun.py`` runs one rank's step), so
nothing is divided by the device count.  ``model_flops`` (6 N D and the
like) comes from the plan's meta and is divided by the device count for
the usefulness ratio.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

# NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU data sheet
# (per card; dense, no sparsity).  The port computes f32 without TF32, so
# f32 products run at the f32 (non-tensor-core) peak.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989.4e12, "f16": 989.4e12,
              "f64": 67e12}
HBM_BW = 3.35e12  # bytes/s, HBM3
NVLINK_BW = 450e9  # bytes/s a direction (NVLink 4: 900 GB/s both ways)


def compute_seconds(flops_by_dtype: dict) -> float:
    """Each dtype's FLOPs at its peak (an unknown dtype at the f32 one)."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["f32"])
               for dt, f in flops_by_dtype.items())


def analyze(rec: dict) -> dict:
    if rec.get("status") != "ok":
        return {"status": rec.get("status", "?"),
                "reason": rec.get("reason") or rec.get("error", "")[:120]}
    nd = rec["n_devices"]
    flops = rec["flops_per_device"]
    membytes = rec["bytes_per_device"]
    mem_min = rec.get("bytes_min_per_device", membytes)
    coll = rec["collective_bytes_per_device"].get("wire_total", 0.0)
    t_c = compute_seconds(rec.get("flops_by_dtype") or {"f32": flops})
    t_hi = membytes / HBM_BW  # no fusion: every op's bytes
    t_lo = mem_min / HBM_BW  # perfect fusion: arguments and results once
    t_m = (t_hi * t_lo) ** 0.5 if t_lo > 0 else t_hi  # geometric midpoint
    t_x = coll / NVLINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    model_flops = rec.get("meta", {}).get("model_flops")
    ratio = (model_flops / nd / flops) if (model_flops and flops) else None
    bound = max(t_c, t_m, t_x)
    frac = t_c / bound if bound > 0 else 0.0
    return {
        "status": "ok",
        "compute_s": t_c,
        "memory_s": t_m,
        "memory_lo_s": t_lo,
        "memory_hi_s": t_hi,
        "collective_s": t_x,
        "bound_s": bound,
        "dominant": dom,
        "model_flops_ratio": ratio,
        "roofline_fraction": frac,  # compute term / dominant term
        "peak_gib": rec["memory"]["peak_estimate"] / 2**30,
    }


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def table(dir_: Path, mesh_filter: str | None = None) -> str:
    rows = []
    for f in sorted(Path(dir_).glob("*.json")):
        rec = json.loads(f.read_text())
        if mesh_filter and rec.get("mesh") != mesh_filter:
            continue
        parts = f.stem.split("__")
        tag = "+".join(p for p in parts[3:] if p != "pbox")
        if tag:  # optimized variant / non-default strategy artifacts
            rec = dict(rec)
            rec["shape"] = rec["shape"] + f"+{tag}"
        a = analyze(rec)
        if a["status"] != "ok":
            rows.append((rec["arch"], rec["shape"], rec.get("mesh", "?"),
                         a["status"], a.get("reason", ""), "", "", "", "", ""))
            continue
        rows.append((
            rec["arch"], rec["shape"], rec["mesh"], "ok",
            fmt_s(a["compute_s"]),
            f"{fmt_s(a['memory_lo_s'])}~{fmt_s(a['memory_hi_s'])}",
            fmt_s(a["collective_s"]), a["dominant"],
            f"{a['model_flops_ratio']:.2f}" if a["model_flops_ratio"] else "-",
            f"{a['peak_gib']:.2f}",
        ))
    hdr = ("arch", "shape", "mesh", "status", "compute", "memory(lo~hi)",
           "collective", "dominant", "MF-ratio", "peakGiB")
    widths = [max(len(str(r[i])) for r in rows + [hdr]) for i in range(len(hdr))]
    lines = ["| " + " | ".join(str(h).ljust(w) for h, w in zip(hdr, widths)) + " |",
             "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(str(c).ljust(w) for c, w in zip(r, widths)) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default=None, help="16x16 or 2x16x16")
    args = ap.parse_args(argv)
    print(table(Path(args.dir), args.mesh))


if __name__ == "__main__":
    main()
