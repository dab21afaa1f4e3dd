#!/usr/bin/env python3
"""Hold the 256-wide fp32 kernels' GroupNorm arithmetic against the CPU on one GPU.

    python3 chip_fp32_gn.py

The fp32 kernels are what `chip_smoke.py`'s `train_parity` holds to the CPU,
and at W = 256 one fp32 Adam step is sensitive to the last bit of every
normalisation. This script builds `lane_layer`, `row_tail` and `edge_mlp`
with variants of `csrc/wide.cuh`'s fp32 GroupNorm (`row_stats`, `gn_el`)
beside the checkout's own build:

- `contracted_fp32`: fp32 sums, (x − μ)·inv·w + b left to nvcc's FMA
  contraction, `rsqrtf`;
- `contracted_f64`: mean and variance in float64, rounded once, the same
  contracted epilogue;
- `plain_order_fp32`: the plain version's op order, each operation rounded
  on its own (no contraction, IEEE sqrt and division), fp32 sums;
- `build`: the checkout's `wide.cuh` (that order, float64 sums).

On the `double` geometry's fp32 eval forward (8 scenarios, seeded weights)
it prints, per kernel call and build, the share of output elements (and of
`lane_layer`'s temp) bitwise equal to the plain version's on the CPU and
the RMS of the difference over the RMS; then, for one fp32 train step as
`train_parity` takes it, each build's parameters farther than `PARAM_FAR`
from the CPU's and its worst gradient leaf, beside the plain ops on the
card and the CPU's own step moved by `TIE_PERTURB`; and the mode score's
bias leaf with the fp32 `Dense` bias gradient summed plainly in fp32.
Before the last line, the card's name and power limit; the last line is
{"ok": true}. Needs CUDA and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LIBS = ("lane_layer", "row_tail", "edge_mlp")

ROW_STATS = {
    "contracted_fp32": """
  const float mu = warp_sum((e[0] + e[1] + e[2] + e[3]) + (e[4] + e[5] + e[6] + e[7])) * (1.f / WW);
  float d[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = e[k] - mu;
  const float var = warp_sum((d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3]) +
                             (d[4] * d[4] + d[5] * d[5] + d[6] * d[6] + d[7] * d[7])) * (1.f / WW);
  return make_float2(mu, rsqrtf(var + eps));
""",
    "contracted_f64": """
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += e[k];
  const double mu = warp_sum_d(s) / WW;
  double q = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) q += ((double)e[k] - mu) * ((double)e[k] - mu);
  return make_float2((float)mu, (float)(1.0 / sqrt(warp_sum_d(q) / WW + eps)));
""",
    "plain_order_fp32": """
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s = __fadd_rn(s, e[k]);
  const float mu = __fmul_rn(warp_sum(s), 1.f / WW);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float d = __fsub_rn(e[k], mu);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  const float var = __fmul_rn(warp_sum(q), 1.f / WW);
  return make_float2(mu, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps))));
""",
}
CONTRACTED_EL = "\n  return (x - mu) * inv * w + b;\n"


def variant_source(text: str, name: str) -> str:
    """wide.cuh with row_stats's body after its `e[8]` line, and for the
    contracted variants gn_el's body, replaced."""
    head = "const float e[8] = {v.lo.x, v.lo.y, v.lo.z, v.lo.w, v.hi.x, v.hi.y, v.hi.z, v.hi.w};\n"
    pat = re.compile(r"(float2 row_stats\(const Row& v, float eps\) \{\n  " + re.escape(head)
                     + r").*?\n\}\n", re.S)
    text, n = pat.subn(lambda m: m.group(1) + ROW_STATS[name].lstrip("\n") + "}\n", text)
    if n != 1:
        raise RuntimeError("wide.cuh: row_stats not found")
    if name.startswith("contracted"):
        pat = re.compile(r"(float gn_el\(float x, float mu, float inv, float w, float b\) \{)"
                         r".*?\n\}\n", re.S)
        text, n = pat.subn(lambda m: m.group(1) + CONTRACTED_EL + "}\n", text)
        if n != 1:
            raise RuntimeError("wide.cuh: gn_el not found")
    return text


def build_variants():
    """{variant: {lib: CDLL}}, every variant's libraries built in parallel."""
    from lanegcn_tpu_torch.ops import cuda

    csrc = ROOT / "lanegcn_tpu_torch" / "csrc"
    wide = (csrc / "wide.cuh").read_text()
    jobs = {}
    for v in ROW_STATS:
        tree = cuda._BUILD / "fp32_gn" / v
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(csrc, tree)
        (tree / "wide.cuh").write_text(variant_source(wide, v))
        for lib in LIBS:
            out = tree / f"lib{lib}.so"
            jobs[v, lib] = (subprocess.Popen(
                [cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(out), str(tree / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    cuda.build_all()
    libs = {"build": {lib: cuda.lib(lib) for lib in LIBS}}
    for (v, lib), (proc, out) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}'s {lib}.cu:\n{log[-4000:]}")
        libs.setdefault(v, {})[lib] = ctypes.CDLL(str(out))
    return libs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_fp32_gn: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models import layers
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.ops import cuda, edge_mlp, lane_layer, row_tail
    from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    libs = build_variants()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0, "variants": list(libs)})

    cfg = cs.pack_config("double", 8)
    packs, _, _, _ = cs.make_packs(cfg, 1, 8, seed0=20_000, pack_kw=cs.pack_kwargs("double"))
    batch = PackedBatch.from_numpy(packs[0])
    bundle = get_model("lanegcn", cfg, device="cpu", seed=2)
    cfg = bundle.config
    start = {k: v.clone() for k, v in bundle.net.state_dict().items()}
    net = get_model("lanegcn", cfg, device="cuda", seed=2).net
    net.load_state_dict(start)
    with cs.forward_capture() as cap:
        make_eval_step(cfg, net)(batch.to("cuda"))

    def agree(k, c):
        """[share of elements bitwise equal, RMS of the difference / RMS]."""
        k, c = k.detach().float().cpu(), c.detach().float().cpu()
        rms = float(c.square().mean().sqrt()) or 1.0
        return [float((k == c).float().mean()), float((k - c).square().mean().sqrt()) / rms]

    def cpu(a):
        return [x.cpu() if isinstance(x, torch.Tensor) else x for x in a]

    plain = {
        "lane_layer": lambda a: lane_layer._tail_plain(
            a[0], lane_layer._temp_plain(*a[:4], a[9]), *a[4:9], 1e-5),
        "row_tail": lambda a: row_tail.row_tail_plain(*a[:7]),
        "edge_mlp": lambda a: edge_mlp.edge_mlp_plain(*a[:12], True, True, 1e-5),
    }
    kernel = {
        "lane_layer": lambda a: lane_layer._fwd_cuda(*a[:10], 1e-5, save_temp=True),
        "row_tail": lambda a: row_tail._fwd_cuda(*a[:7], 1e-5),
        "edge_mlp": lambda a: edge_mlp._fwd_cuda(*a[:12], 1e-5),
    }
    for name in LIBS:
        for key, a in cap.calls[name].items():
            a = [x.detach() if isinstance(x, torch.Tensor) else x for x in a]
            out_c = plain[name](cpu(a))
            row = {"plain_on_card": {"out": agree(plain[name](a), out_c)}}
            temp_c = lane_layer._temp_plain(*cpu(a)[:4], a[9]) if name == "lane_layer" else None
            for v, ls in libs.items():
                cuda._LIBS.update(ls)
                got = kernel[name](a)
                if name == "lane_layer":
                    row[v] = {"out": agree(got[0], out_c), "temp": agree(got[1], temp_c)}
                else:
                    row[v] = {"out": agree(got, out_c)}
            cs.emit({"phase": "forward", "kernel": name, "shape": list(key[0]),
                     "equal_share_rms_rel": row})
    cuda._LIBS.update(libs["build"])

    def lane_plain(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, shifts, eps, save_temp=False):
        temp = lane_layer._temp_plain(feat, pre, masks, wb, shifts)
        out = lane_layer._tail_plain(feat, temp, w2, g1w, g1b, g2w, g2b, eps)
        return (out, temp) if save_temp else out

    plain_fwd = [(lane_layer, "_fwd_cuda", lane_plain),
                 (row_tail, "_fwd_cuda", lambda *a: row_tail.row_tail_plain(*a)),
                 (edge_mlp, "_fwd_cuda",
                  lambda *a: edge_mlp.edge_mlp_plain(*a[:12], True, True, a[12]))]
    dense_forward = layers.Dense.forward

    def dense_fp32_bias(self, x):  # the bias gradient summed by autograd in fp32
        y = x.to(self.dtype) @ self.weight.to(self.dtype).t()
        return y if self.bias is None else y + self.bias.to(self.dtype)

    def step(device, move=0, on_plain=False):
        saved = [(m, n, getattr(m, n)) for m, n, _ in plain_fwd]
        if on_plain:
            for m, n, f in plain_fwd:
                setattr(m, n, f)
        try:
            net = get_model("lanegcn", cfg, device=device, seed=2).net
            net.load_state_dict(start)
            if move:
                gen = torch.Generator().manual_seed(move)
                with torch.no_grad():
                    for p in net.parameters():
                        noise = torch.randn(p.shape, generator=gen).to(p.device)
                        p.mul_(1 + cs.TIE_PERTURB * noise)
            net, state = init_state(cfg, net=net, device=device)
            make_train_step(cfg, net, state, device=device, loss_fn=bundle.loss_fn,
                            metrics_fn=bundle.metrics_fn)(batch, 0.0)
            return ({n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()},
                    {n: p.detach().cpu().clone() for n, p in net.named_parameters()})
        finally:
            for m, n, f in saved:
                setattr(m, n, f)

    for bias in ("float64", "fp32"):
        layers.Dense.forward = dense_forward if bias == "float64" else dense_fp32_bias
        g_c, p_c = step("cpu")
        top = max(float(g.abs().max()) for g in g_c.values())
        scales = {n: max(float(g.abs().max()), cs.GRAD_FLOOR * top) for n, g in g_c.items()}
        n_params = sum(p.numel() for p in p_c.values())

        def report(tag, g, p):
            shares = {n: float((g[n] - g_c[n]).abs().max()) / (cs.GRAD_TOL * scales[n])
                      for n in g_c}
            worst = max(shares, key=shares.get)
            far = {n: (p[n] - p_c[n]).abs() > cs.PARAM_FAR for n in p_c}
            g_far = torch.cat([g_c[n][far[n]] for n in g_c]).abs()
            small = int(((g_far >= 1e-8) & (g_far < 1e-6)).sum())
            cs.emit({"phase": "train_step", "dense_bias_grad": bias, "against_cpu": tag,
                     "params_far": sum(int(f.sum()) for f in far.values()),
                     "params_far_limit": cs.PARAM_FAR_SHARE * n_params,
                     "far_with_abs_grad_1e-8_to_1e-6": small,
                     "worst_grad_leaf": [worst, shares[worst]],
                     "cls_bias_grad_err_over_tol": shares["pred_net.cls.1.bias"]})

        if bias == "float64":
            report("cpu_moved_by_tie_perturb", *step("cpu", move=1))
            report("plain_on_card", *step("cuda", on_plain=True))
            for v, ls in libs.items():
                cuda._LIBS.update(ls)
                report(v, *step("cuda"))
            cuda._LIBS.update(libs["build"])
        else:
            report("build", *step("cuda"))
    layers.Dense.forward = dense_forward
    print(smi, flush=True)
    cs.emit({"ok": True})


if __name__ == "__main__":
    main()
