"""Design sweeps of the port's two redesigned kernels, on one H100.

    python3 scripts/torch_kernel_sweep.py [--iters N]

Backs the fixed choices in ``kernels/csrc/matmul_tiled.cu`` and
``kernels/csrc/decode_attention.cu`` with times taken on the card:

- ``matmul_tiled`` bf16 above T = 32: eight output-tile shapes (BM x BN x
  BK, warps, ring stages) at the serving-chunk and training shapes;
- ``matmul_tiled`` bf16 at T <= 32: the split-K count at decode (T = 4)
  and verify (T = 20), against the count the kernel's plan picks;
- ``decode_attention``: the keys per block range L, against the L the
  kernel's plan picks, at the chip_smoke table shape, a qwen2-7b decode
  step and recurrentgemma-2b's heads.

Each variant is built from the committed sources (a generated file that
includes the kernel's ``.cu`` and instantiates the variant), checked
against ``torch.matmul`` or the plain decode version, and timed by the
profiler's device time of the whole call, inputs rotated past the L2 as
``chip_smoke.py`` does; the library call (``torch.matmul``, SDPA) on the
same clock.  Prints one line per shape and writes
``chiprun_out/kernel_sweep.json``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (BM, BN, BK, warps along M, warps along N, stages); the first two are
# the kernel's own choices for T <= 256 and for larger T
MM_TILES = [(64, 64, 64, 2, 2, 4), (64, 128, 64, 2, 4, 3),
            (64, 64, 64, 2, 2, 3), (64, 64, 32, 2, 2, 4),
            (64, 128, 32, 2, 4, 4), (128, 64, 64, 4, 2, 3),
            (128, 128, 32, 2, 4, 3), (32, 128, 64, 1, 4, 4)]
# (T, D, F): qwen2-7b QKV at a ragged, a partial and a full 256-token
# chunk; recurrentgemma-2b's; famous-bert's training X.W, dX and dW
MM_SHAPES = [(100, 3584, 4608), (200, 3584, 4608), (256, 3584, 4608),
             (256, 2560, 3072), (4096, 768, 2304), (4096, 2304, 768),
             (768, 4096, 2304)]
MM_SPLITS = [1, 2, 4, 7, 14]
MM_SPLIT_SHAPES = [(4, 3584, 4608), (20, 3584, 4608), (4, 2560, 3072)]
# (label, B, H, KV, dh, lens), Skv = 2048
DEC_SHAPES = [("table", 4, 28, 4, 128, [1, 37, 1000, 2048]),
              ("qwen2-7b step", 4, 28, 4, 128, [1025] * 4),
              ("recurrentgemma-2b step", 4, 10, 1, 256, [1025] * 4)]
DEC_SKV = 2048
DEC_L = [16, 32, 64, 128, 256]


def sweep_sources() -> dict[str, str]:
    """The generated CUDA files: each includes one kernel source and adds
    a launcher per tile shape or the decode workspace size."""
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    cases = "\n".join(
        f"    case {i}: e = launch_bf16<{bm}, {bn}, {bk}, {wm}, {wn}, {st}>("
        "xb, wb, ob, nullptr, T, D, F, 1, vec, s); break;"
        for i, (bm, bn, bk, wm, wn, st) in enumerate(MM_TILES))
    mm = f"""#include "{csrc / 'matmul_tiled.cu'}"

extern "C" int sweep_mm(int cfg, const void* x, const void* w, void* out,
                        int T, int D, int F, void* stream) {{
  using namespace famous;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = D % 8 == 0 && F % 8 == 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{cases}
  }}
  return static_cast<int>(e);
}}
"""
    dec = f"""#include "{csrc / 'decode_attention.cu'}"

extern "C" long long sweep_decode_ws(int R, int H, int dh, int Skv, int L) {{
  return famous::decode_ws_elems(R, H, dh, Skv, L);
}}
"""
    return {"sweep_mm.cu": mm, "sweep_decode.cu": dec}


def build(out_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import lib

    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = []
    for name, text in sweep_sources().items():
        (out_dir / name).write_text(text)
        srcs.append(str(out_dir / name))
    so = out_dir / "libsweep.so"
    run = subprocess.run(
        [lib.nvcc_path(), *lib.ARCH_FLAGS, *lib.NVCC_FLAGS, "-shared",
         "-o", str(so), *srcs, str(lib.CSRC / "errors.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}")
    so_lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    so_lib.sweep_mm.argtypes = [I, P, P, P, I, I, I, P]
    so_lib.sweep_decode_ws.argtypes = [I, I, I, I, I]
    so_lib.sweep_decode_ws.restype = ctypes.c_longlong
    for name in ("famous_matmul_tiled", "famous_decode_attention"):
        getattr(so_lib, name).argtypes = lib._SIGNATURES[name]
    for fn in (so_lib.sweep_mm, so_lib.famous_matmul_tiled,
               so_lib.famous_decode_attention):
        fn.restype = I
    return so_lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as Fn

    import chip_smoke as cs
    from repro_torch.kernels import lib
    from repro_torch.kernels.decode import decode_attn
    from repro_torch.kernels.decode import ref as dec_ref
    from repro_torch.kernels.qkv import qkv_proj

    dev = torch.device("cuda")
    lib.load()   # the port's library: the plans and error strings
    so = build(ROOT / "build" / "sweep")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = lib.sm_count(dev)
    code = lib.DTYPE_CODE[torch.bfloat16]
    it = args.iters
    smi = cs.smi_line()
    print(f"card: {smi}", flush=True)
    result = {"card": smi, "matmul_tiles": [], "matmul_splits": [],
              "decode_L": []}

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def dev_ms(fn, sets):
        return cs.device_ms(torch, fn, sets, it)

    # matmul_tiled above T = 32: output-tile shapes
    for T, D, F in MM_SHAPES:
        sets = [(randn((T, D)), randn((D, F), D ** -0.5))
                for _ in range(cs.n_sets((T * D + D * F) * 2))]
        ref = torch.matmul(sets[0][0].float(), sets[0][1].float())
        row = {"T": T, "D": D, "F": F, "library_ms": dev_ms(torch.matmul,
                                                            sets)}
        for i, tile in enumerate(MM_TILES):
            def kern(x, w, i=i):
                out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                                  device=dev)
                lib.check("sweep_mm", so.sweep_mm(
                    i, x.data_ptr(), w.data_ptr(), out.data_ptr(), T, D, F,
                    stream()))
                return out
            err, ok = cs.compare(torch, kern(*sets[0]), ref, cs.TOL["bf16"])
            name = "{}x{}x{} w{}x{} s{}".format(*tile)
            row[name] = {"ms": dev_ms(kern, sets), "max_abs_err": err,
                         "ok": ok}
        result["matmul_tiles"].append(row)
        print(f"matmul_tiled T={T} D={D} F={F}: torch.matmul "
              f"{row['library_ms']:.4f} ms | " + " | ".join(
                  f"{k} {v['ms']:.4f}{'' if v['ok'] else ' WRONG'}"
                  for k, v in row.items() if isinstance(v, dict)),
              flush=True)
        del sets

    # matmul_tiled at T <= 32: split-K counts through the kernel's entry
    for T, D, F in MM_SPLIT_SHAPES:
        sets = [(randn((T, D)), randn((D, F), D ** -0.5))
                for _ in range(cs.n_sets((T * D + D * F) * 2))]
        ref = torch.matmul(sets[0][0].float(), sets[0][1].float())
        chosen, _ = qkv_proj._plan(code, T, D, F, sms)
        row = {"T": T, "D": D, "F": F, "plan_splits": chosen,
               "library_ms": dev_ms(torch.matmul, sets)}
        for n in sorted(set(MM_SPLITS + [chosen])):
            # the split partials: n x T x F f32 (matmul_tiled.cu's plan)
            part = torch.empty(n * T * F, dtype=torch.float32, device=dev)

            def kern(x, w, n=n, part=part):
                out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                                  device=dev)
                lib.check("famous_matmul_tiled", so.famous_matmul_tiled(
                    code, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    part.data_ptr() if n > 1 else None, n, T, D, F,
                    stream()))
                return out
            err, ok = cs.compare(torch, kern(*sets[0]), ref, cs.TOL["bf16"])
            row[f"splits={n}"] = {"ms": dev_ms(kern, sets),
                                  "max_abs_err": err, "ok": ok}
        result["matmul_splits"].append(row)
        print(f"matmul_tiled T={T} D={D} F={F} (plan: {chosen} splits): "
              f"torch.matmul {row['library_ms']:.4f} ms | " + " | ".join(
                  f"{k} {v['ms']:.4f}{'' if v['ok'] else ' WRONG'}"
                  for k, v in row.items() if isinstance(v, dict)),
              flush=True)
        del sets

    # decode_attention: keys per block range
    Skv = DEC_SKV
    for label, B, H, KV, dh, lens_list in DEC_SHAPES:
        scale = dh ** -0.5
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        mask = (torch.arange(Skv, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        sets = [(randn((B, H, dh)), randn((B, Skv, KV, dh)),
                 randn((B, Skv, KV, dh)))
                for _ in range(cs.n_sets(4 * B * Skv * KV * dh))]
        ref = dec_ref.decode_reference(*sets[0], lens, scale=scale)
        chosen, _ = decode_attn.plan(code, B, H, KV, dh, Skv, sms)

        def library(q, k, v):
            return Fn.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, scale=scale, enable_gqa=True)
        row = {"shape": label, "B": B, "H": H, "KV": KV, "dh": dh,
               "lens": lens_list, "plan_L": chosen,
               "library_ms": dev_ms(library, sets)}
        for L in DEC_L:
            ws = torch.empty(so.sweep_decode_ws(B, H, dh, Skv, L),
                             dtype=torch.float32, device=dev)

            def kern(q, k, v, L=L, ws=ws):
                out = torch.empty_like(q)
                err = so.famous_decode_attention(
                    code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lens.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H,
                    KV, dh, Skv, 1, L, *k.stride()[:3], *v.stride()[:3],
                    scale, stream())
                if err:
                    raise RuntimeError(f"L={L}: CUDA error {err}")
                return out
            try:
                out = kern(*sets[0])
            except RuntimeError as e:   # K and V past shared memory
                torch.cuda.synchronize()
                row[f"L={L}"] = {"ms": None, "error": str(e)}
                continue
            err, ok = cs.compare(torch, out, ref, cs.ATTN_TOL["bf16"])
            row[f"L={L}"] = {"ms": dev_ms(kern, sets), "max_abs_err": err,
                             "ok": ok}
        result["decode_L"].append(row)
        print(f"decode_attention {label} B={B} H={H} KV={KV} dh={dh} "
              f"lens={lens_list} (plan: L={chosen}): SDPA "
              f"{row['library_ms']:.4f} ms | " + " | ".join(
                  f"{k} " + ("n/a" if v["ms"] is None else
                             f"{v['ms']:.4f}{'' if v['ok'] else ' WRONG'}")
                  for k, v in row.items() if isinstance(v, dict)),
              flush=True)
        del sets

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_sweep.json").write_text(json.dumps(result, indent=1))
    bad = [k for sec in ("matmul_tiles", "matmul_splits", "decode_L")
           for row in result[sec] for k, v in row.items()
           if isinstance(v, dict) and v.get("ok") is False]
    print(json.dumps({"ok": not bad, "wrong": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
