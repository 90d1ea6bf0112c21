#!/usr/bin/env python3
"""Hold flash attention's (K5) bf16 tolerances, the forward's and the
backward's, against the card's errors and against planted faults. Needs one
CUDA card and nvcc:

    PYTHONPATH=src python3 tools/flash_tolerance.py --out DIR [--seeds 3]
    PYTHONPATH=src python3 tools/flash_tolerance.py --backward --out DIR

Builds ``kernels/csrc/flash_attention.cu`` as it is and four copies with
one fault planted in each, all into DIR (a directory outside the
checkout):

* ``drop_last_kv_tile``: every q tile past the first skips its last K/V
  tile, the one on the causal diagonal;
* ``no_mask_wg1_diagonal``: the second consumer warpgroup takes no mask on
  the diagonal tile, so its rows see up to 64 later keys;
* ``last_v_from_wrong_stage``: the last O += P V reads V from the ring's
  next stage, which holds an older tile;
* ``stale_v_tile_15``: K/V tile 15 (keys 1,920-2,047) gets the V of tile
  12, which its stage held before, as a missed wait would leave it; only
  rows past 1,920 see it, each with a share of 1/16 or less.

Runs every build at the bf16 cases of ``tests/test_torch_cuda_flash.py``
(random q, k, v from ``--seeds`` seeds) against the plain version on the
inputs cast to f32, and prints for each build and case: the largest
|err|, the atol that ``ref.BF16_RTOL`` would need, the worst ratio of
|err| to the limit ``ref.BF16_ATOL + ref.BF16_RTOL |want|``, and the worst
ratio to the earlier limit, 3e-2 absolute and relative against the plain
version's bf16 output. Exits nonzero unless the sound build is within the
limit everywhere and each fault exceeds it somewhere.

``--backward`` does the same for the backward kernels (``ref.BWD_BF16_ATOL``
+ ``ref.BWD_BF16_RTOL`` |want| on dQ, dK and dV, each from the build's own
forward O and LSE, against ``ref.flash_attention_bwd_ref`` on the inputs
cast to f32 with the plain forward's O and LSE), with these faults:

* ``dkdv_skips_diagonal_q_tile``: every wgmma dK/dV CTA starts one q tile
  late under the causal mask, skipping the tile on its diagonal;
* ``ds_without_delta``: both wgmma kernels (dQ and dK/dV) take dS = P o dP,
  without the ``- delta``;
* ``last_k_from_wrong_stage``: the last dQ += dS K of each wgmma dQ CTA
  that sees more than one key tile reads K from the ring's stage before,
  which holds the previous tile, as a stage index off by one would.

The faults sit in the kernels that bf16 at D = 64, 96 and 128 runs; the
mma.sync kernels at D = 16 and 32 run sound in every build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

FAULTS = {
    "drop_last_kv_tile": (
        "  if (causal) n_tiles = min(n_tiles, (q0 + kM + kN - 1) / kN);\n",
        "  if (causal) n_tiles = min(n_tiles, (q0 + kM + kN - 1) / kN);\n"
        "  n_tiles -= n_tiles > 1;\n"),
    "no_mask_wg1_diagonal": (
        "return kv0 + kN > skv || (causal && kv0 + kN - 1 > row_first);",
        "return kv0 + kN > skv ||\n"
        "             (causal && w == 0 && kv0 + kN - 1 > row_first);"),
    "last_v_from_wrong_stage": (
        "mma_ab<D, kN>(acc, pa, sv + sl * T::kBytes);",
        "mma_ab<D, kN>(acc, pa, sv + ((sl + 1) % kStages) * T::kBytes);"),
    "stale_v_tile_15": (
        "&tv, bv + 8 * st,\n                   c * T::kCW, hk, j * kN, b);",
        "&tv, bv + 8 * st,\n                   c * T::kCW, hk,"
        " (j == 15 ? j - kStages : j) * kN, b);"),
}
# (B, S, Skv, H, Hkv, D, causal): the bf16 cases of the card tests.
CASES = (
    (1, 2048, 2048, 28, 4, 128, True), (1, 777, 777, 28, 4, 128, True),
    (2, 100, 100, 4, 2, 16, True), (1, 130, 130, 8, 8, 64, False),
    (1, 45, 170, 4, 2, 64, True), (1, 1, 1, 28, 4, 128, True),
    (1, 127, 127, 28, 4, 128, True), (1, 128, 128, 28, 4, 128, True),
    (1, 129, 129, 28, 4, 128, True), (1, 2047, 2047, 28, 4, 128, True),
    (2, 300, 300, 32, 32, 96, True), (1, 333, 333, 16, 2, 64, True),
    (2, 200, 200, 28, 4, 128, True), (1, 300, 300, 28, 4, 128, False),
    (2, 45, 170, 8, 2, 96, False), (1, 300, 100, 28, 4, 128, True),
)
OLD_TOL = 3e-2
# Backward faults: each a list of (line, replacement) planted together.
BWD_FAULTS = {
    "dkdv_skips_diagonal_q_tile": [(
        "const int i_first = causal ? min(k0 / kBwdRows, n_q) : 0;",
        "const int i_first = causal ? min(k0 / kBwdRows + 1, n_q) : 0;")],
    "ds_without_delta": [
        ("dpt[i] = p * (dpt[i] - dls[st][col]);", "dpt[i] = p * dpt[i];"),
        ("dp[i] = p * (dp[i] - ((i & 2) ? dl1 : dl0));",
         "dp[i] = p * dp[i];")],
    "last_k_from_wrong_stage": [(
        "mma_ab<D, kN>(acc, sa, k_st);  // dQ += dS K",
        "mma_ab<D, kN>(acc, sa, j == 0 || j + 1 < n_kv ? k_st : skv_ring +"
        " (st + kS - 1) % kS * 2 * T::kBytes);")],
}
# (B, S, Skv, H, Hkv, D, causal): the training shape, the backward's bf16
# card cases and the shapes chip_smoke.py checks.
BWD_CASES = (
    (4, 2048, 2048, 28, 4, 128, True), (1, 777, 777, 28, 4, 128, True),
    (1, 129, 129, 28, 4, 128, True), (2, 300, 300, 32, 32, 96, True),
    (2, 100, 100, 4, 2, 16, True), (1, 130, 130, 8, 8, 64, False),
    (2, 45, 170, 8, 2, 32, True), (1, 300, 100, 28, 4, 128, True),
    (1, 300, 300, 28, 4, 128, False), (1, 65, 65, 28, 4, 128, True),
    (1, 333, 333, 16, 2, 64, True), (1, 2048, 2048, 32, 32, 96, True),
    (1, 200, 72, 28, 4, 128, True),
)


def build_all(out: Path, faults: dict) -> dict[str, ctypes.CDLL]:
    """nvcc the sound source and each faulty copy at once; name -> CDLL.
    ``faults``: name -> list of (line, replacement)."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    jobs = {}
    for name, pairs in [("sound", [])] + list(faults.items()):
        text = src
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the planted line is not in the "
                                   f"source once")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(d / "libflash_attention.so"), str(d / "flash_attention.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / name / "libflash_attention.so"))
        for fn, n_ptr in (("flash_attention_fwd", 5),
                          ("flash_attention_bwd", 10)):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(lib, q, k, v, causal: bool, lse=None) -> torch.Tensor:
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, k.shape[1], h,
        k.shape[2], d, 1, int(causal),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd returned {err}")
    torch.cuda.synchronize()
    return out


def run_bwd(lib, q, k, v, do, causal: bool):
    """dq, dk, dv from the build's own forward (O and LSE)."""
    b, s, h, d = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out = run(lib, q, k, v, causal, lse)
    delta = torch.empty_like(lse)
    grads = [torch.empty_like(x) for x in (q, k, v)]
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(g.data_ptr() for g in grads), b, s, k.shape[1], h, k.shape[2], d,
        1, int(causal), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd returned {err}")
    torch.cuda.synchronize()
    return grads


def main_bwd(args) -> int:
    """The backward's limit against the sound build and BWD_FAULTS."""
    libs = build_all(args.out, BWD_FAULTS)
    dev = torch.device("cuda")
    worst = {name: {"ratio": 0.0, "atol_needed": 0.0, "max_abs_err": 0.0}
             for name in libs}
    for case in BWD_CASES:
        b, s, skv, h, hkv, d, causal = case
        for seed in range(args.seeds):
            g = torch.Generator(device=dev).manual_seed(seed)
            q, k, v, do = (torch.randn((b, n_s, n, d), generator=g,
                                       device=dev).bfloat16()
                           for n_s, n in ((s, h), (skv, hkv), (skv, hkv),
                                          (s, h)))
            qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
            o_ref, lse_ref = ref.flash_attention_lse_ref(qf, kf, vf,
                                                         causal=causal)
            want = ref.flash_attention_bwd_ref(qf, kf, vf, o_ref, dof,
                                               lse_ref, causal)
            for name, lib in libs.items():
                r = {"ratio": 0.0, "atol_needed": 0.0, "max_abs_err": 0.0}
                for got, w in zip(run_bwd(lib, q, k, v, do, causal), want):
                    err = (got.float() - w).abs().nan_to_num(
                        nan=float("inf"))
                    r["max_abs_err"] = max(r["max_abs_err"],
                                           float(err.max()))
                    r["atol_needed"] = max(r["atol_needed"], float(
                        (err - ref.BWD_BF16_RTOL * w.abs()).max()))
                    r["ratio"] = max(r["ratio"], float(
                        (err / (ref.BWD_BF16_ATOL + ref.BWD_BF16_RTOL
                                * w.abs())).max()))
                for key, x in r.items():
                    worst[name][key] = max(worst[name][key], x)
                print(f"[tol-bwd] {name} {case} seed {seed}: " + ", ".join(
                    f"{key} {x}" for key, x in r.items()), flush=True)
            del q, k, v, do, qf, kf, vf, dof, o_ref, lse_ref, want
    print(json.dumps({"backward_limit": {"atol": ref.BWD_BF16_ATOL,
                                         "rtol": ref.BWD_BF16_RTOL},
                      "worst": worst}))
    ok = worst["sound"]["ratio"] <= 1 and all(
        worst[name]["ratio"] > 1 for name in BWD_FAULTS)
    print(f"[tol-bwd] sound within the limit and every fault beyond it: "
          f"{ok}")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--backward", action="store_true",
                    help="hold the backward's limit instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.backward:
        return main_bwd(args)
    libs = build_all(args.out, {k: [v] for k, v in FAULTS.items()})
    dev = torch.device("cuda")
    worst = {name: {"ratio": 0.0, "old_ratio": 0.0, "atol_needed": 0.0,
                    "max_abs_err": 0.0} for name in libs}
    for case in CASES:
        b, s, skv, h, hkv, d, causal = case
        for seed in range(args.seeds):
            g = torch.Generator(device=dev).manual_seed(seed)
            q, k, v = (torch.randn((b, n_s, n, d), generator=g, device=dev
                                   ).bfloat16()
                       for n_s, n in ((s, h), (skv, hkv), (skv, hkv)))
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           causal=causal)
            want16 = ref.flash_attention_ref(q, k, v, causal=causal).float()
            for name, lib in libs.items():
                got = run(lib, q, k, v, causal).float()
                # A NaN counts as an infinite error, not as none.
                err = (got - want).abs().nan_to_num(nan=float("inf"))
                r = {"max_abs_err": float(err.max()),
                     "atol_needed": float(
                         (err - ref.BF16_RTOL * want.abs()).max()),
                     "ratio": float((err / (ref.BF16_ATOL + ref.BF16_RTOL
                                            * want.abs())).max()),
                     "old_ratio": float(((got - want16).abs().nan_to_num(
                         nan=float("inf")) / (OLD_TOL + OLD_TOL
                                              * want16.abs())).max())}
                for key, x in r.items():
                    worst[name][key] = max(worst[name][key], x)
                print(f"[tol] {name} {case} seed {seed}: " + ", ".join(
                    f"{key} {x}" for key, x in r.items()), flush=True)
    print(json.dumps({"limit": {"atol": ref.BF16_ATOL,
                                "rtol": ref.BF16_RTOL},
                      "worst": worst}))
    ok = worst["sound"]["ratio"] <= 1 and all(
        worst[name]["ratio"] > 1 for name in FAULTS)
    print(f"[tol] sound within the limit and every fault beyond it: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
