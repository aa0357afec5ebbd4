"""Device-memory bandwidth probe ladder — the port of tools/hbm_bw.py.

Modes:
- `--mode dma` (default): the read probe (ops/hbm_bw.py::dma_read, K24),
  whose only work is bulk copies of (bm, 1024) int8 blocks into shared
  memory: what the card delivers to a read-only stream, the access of the
  decode step's weights, without a compute kernel grading itself.
- `--mode copy`: the same blocks copied back out (dma_copy, K25): read and
  write traffic.
- `--mode wshape`: reads in the Q8 weight stream's (bk, bn) tiles
  (wshape_read, K26).
- `--mode dmadeep`: reads with `depth` bulk copies in flight on every SM
  (deep_read, K27).
- `--mode xreduce`: PyTorch's own int8 reduction, independent of the port's
  kernels.
- `--mode vpu`: a convert-and-reduce chain at the elementwise rate.

Each pass is chained to the previous one (its seed, a device int32, depends
on the pass index and on the previous pass's result), `reps` passes are
timed with CUDA events, and the best of 3 timings counts. The fractions
are of the NVIDIA H100 SXM data sheet's 3.35 TB/s. The port bench
(hip_llama_tpu_torch/bench.py) takes the best of the dma ladder, wshape,
dmadeep and xreduce as its achievable bandwidth (`achievable`).

Run on the card:  python -m hip_llama_tpu_torch.tools.hbm_bw [--mode ...]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from hip_llama_tpu_torch.models.params import resolve_device
from hip_llama_tpu_torch.ops import hbm_bw as K

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3, in GB/s
SPEC_GBPS = 3350.0


def dma_sizes(gb: float, streams: int, block_kib: int) -> dict[str, int]:
    """The read and copy probes' array: n rows of 1024 int8 in n_blocks
    blocks of bm rows, per blocks to each of `streams` regions."""
    bm = block_kib  # (bm, 1024) int8 blocks = bm KiB
    chunk = bm * streams
    n = int(gb * 2 ** 30) // (chunk * 1024) * chunk
    n_blocks = n // bm
    return dict(bm=bm, n=n, n_blocks=n_blocks, per=n_blocks // streams)


def wshape_sizes(gb: float, bk: int, bn: int) -> dict[str, int]:
    """The wshape probe's (bk, n_cols) array and its n_blocks tiles."""
    n_cols = int(gb * 2 ** 30) // bk // bn * bn
    return dict(n_cols=n_cols, n_blocks=n_cols // bn)


def deep_sizes(gb: float, block_kib: int) -> dict[str, int]:
    """The deep probe's array: n rows in n_blocks blocks of bm rows."""
    bm = block_kib
    n = int(gb * 2 ** 30) // (bm * 1024) * bm
    return dict(bm=bm, n=n, n_blocks=n // bm)


def xreduce_cols(gb: float) -> int:
    """Columns of the xreduce probe's (4096, n) array."""
    return int(gb * 2 ** 30) // 4096


def _best_of_3(chain, x) -> float:
    """Seconds of the fastest of 3 calls of chain(x) after a warm one: CUDA
    events on the card, the host clock on the CPU."""
    cuda = x.device.type == "cuda"
    chain(x)
    best = float("inf")
    for _ in range(3):
        if cuda:
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            chain(x)
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            chain(x)
            best = min(best, time.perf_counter() - t0)
    return best


def _seeded_chain(call, reps: int, copy: bool = False):
    """`reps` passes of call(seed, x), each seed an int32 on x's device made
    from the pass index and the previous pass's result."""

    def chain(x):
        s = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(reps):
            res = call((s.to(torch.int32) + i).reshape(1), x)
            first = res[0] if copy else res
            s = s + first[0, 0].float() * 1e-30
        return s

    return chain


def dma_probe(gb: float = 6.0, copy: bool = False, reps: int = 4, streams: int = 4,
              block_kib: int = 4096, device="cuda") -> float:
    """Bulk-copy bandwidth: (bm, 1024) int8 blocks of `streams` disjoint
    regions, read (K24) or copied (K25). Returns GB/s of device-memory
    traffic (reads, + writes for copy)."""
    dev = resolve_device(device)
    sz = dma_sizes(gb, streams, block_kib)
    x = torch.ones((sz["n"], 1024), dtype=torch.int8, device=dev)
    if copy:
        chain = _seeded_chain(lambda seed, x: K.dma_copy(x, sz["bm"], streams), reps, copy=True)
    else:
        chain = _seeded_chain(lambda seed, x: K.dma_read(seed, x, sz["bm"], streams), reps)
    best = _best_of_3(chain, x)
    return reps * sz["n"] * 1024 * (2 if copy else 1) / best / 1e9


def wshape_probe(gb: float = 6.0, reps: int = 4, bk: int = 4096, bn: int = 512,
                 device="cuda") -> float:
    """Compute-free reads in the Q8 weight stream's access pattern: (bk,
    bn) int8 tiles along the columns of a (bk, n_cols) array (K26)."""
    dev = resolve_device(device)
    sz = wshape_sizes(gb, bk, bn)
    x = torch.ones((bk, sz["n_cols"]), dtype=torch.int8, device=dev)
    best = _best_of_3(_seeded_chain(lambda seed, x: K.wshape_read(seed, x, bn), reps), x)
    return reps * bk * sz["n_cols"] / best / 1e9


def deep_probe(gb: float = 6.0, reps: int = 4, depth: int = 8, block_kib: int = 2048,
               device="cuda") -> float:
    """Reads with `depth` bulk copies kept in flight on every SM (K27)."""
    dev = resolve_device(device)
    sz = deep_sizes(gb, block_kib)
    x = torch.ones((sz["n"], 1024), dtype=torch.int8, device=dev)
    best = _best_of_3(
        _seeded_chain(lambda seed, x: K.deep_read(seed, x, sz["bm"], depth), reps), x)
    return reps * sz["n"] * 1024 / best / 1e9


def xreduce_probe(gb: float = 6.0, reps: int = 4, device="cuda") -> float:
    """PyTorch's int8 sum over `gb` GiB, chained `reps` times: a reduction
    independent of the port's kernels. Each pass runs (eager PyTorch hoists
    nothing out of the loop; the pass index still scales the sum). The sum
    stays int32, as jnp.sum of int32 does (PyTorch's default would widen to
    int64, through an int64 copy). The GB/s counts the int8 bytes; eager
    PyTorch also writes and reads the int32 copy, which XLA fuses away and
    the figure does not count."""
    dev = resolve_device(device)
    n = xreduce_cols(gb)
    x = torch.ones((4096, n), dtype=torch.int8, device=dev)

    def chain(x):
        s = torch.zeros((), dtype=torch.int32, device=x.device)
        for i in range(reps):
            s = s + x.to(torch.int32).sum(dtype=torch.int32) * (i + 1)
        return s

    best = _best_of_3(chain, x)
    return reps * 4096 * n / best / 1e9


def vpu_main(device="cuda") -> None:
    dev = resolve_device(device)
    results = {}
    for name, dtype, gb in (
        ("int8_6gb", torch.int8, 6.0),
        ("bf16_6gb", torch.bfloat16, 6.0),
        ("f32_4gb", torch.float32, 4.0),
    ):
        itemsize = torch.tensor([], dtype=dtype).element_size()
        n = int(gb * 2 ** 30 / itemsize / 1024) * 1024
        x = torch.ones((n // 1024, 1024), dtype=dtype, device=dev)
        reps = 8

        def rsum(x):
            s = torch.zeros((), dtype=torch.float32, device=x.device)
            for _ in range(reps):
                s = s + (x.float() + s * 1e-30).sum()
            return s

        best = _best_of_3(rsum, x)
        bw = reps * n * itemsize / best / 1e9
        results[name] = round(bw, 1)
        print(f"{name}: {bw:.1f} GB/s convert-and-reduce lower bound "
              f"({reps} x {n * itemsize / 2**30:.1f} GiB in {best:.3f} s)")
        del x
    print(f"best lower bound / spec {SPEC_GBPS:.0f} GB/s = "
          f"{max(results.values()) / SPEC_GBPS:.3f}")


def achievable(device="cuda", file=sys.stderr) -> float:
    """The port bench's achievable bandwidth in bytes/s: the best of the
    dma read ladder (streams 1, 2, 4, 8 at `main`'s 2048 KiB blocks),
    wshape, dmadeep and xreduce at their defaults; each figure to `file`."""
    best = 0.0
    for st in (1, 2, 4, 8):
        bw = dma_probe(streams=st, block_kib=2048, device=device)
        print(f"  dma streams={st}: {bw:.1f} GB/s", file=file, flush=True)
        best = max(best, bw)
    for name, probe in (("wshape", wshape_probe), ("dmadeep", deep_probe),
                        ("xreduce", xreduce_probe)):
        bw = probe(device=device)
        print(f"  {name}: {bw:.1f} GB/s", file=file, flush=True)
        best = max(best, bw)
    print(f"achievable: {best:.1f} GB/s = {best / SPEC_GBPS:.3f} of spec; "
          f"HIPLLAMA_ACHIEVABLE_BW={best * 1e9:.4e}", file=file, flush=True)
    return best * 1e9


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="dma",
                    choices=["dma", "copy", "vpu", "wshape", "dmadeep", "xreduce"])
    ap.add_argument("--gb", type=float, default=6.0)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--streams", type=int, default=0,
                    help="concurrent block streams; 0 = ladder over 1/2/4/8 "
                         "and report the max")
    ap.add_argument("--block-kib", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions, for a dry run")
    a = ap.parse_args(argv)
    dev = a.device
    if a.mode == "xreduce":
        bw = xreduce_probe(gb=a.gb, reps=a.reps, device=dev)
        print(f"torch_reduce: {bw:.1f} GB/s = {bw / SPEC_GBPS:.3f} of spec; "
              f"HIPLLAMA_ACHIEVABLE_BW={bw * 1e9:.4e}", flush=True)
        return
    if a.mode == "dmadeep":
        best = 0.0
        for depth in (2, 4, 8, 16):
            bw = deep_probe(gb=a.gb, reps=a.reps, depth=depth, block_kib=a.block_kib,
                            device=dev)
            print(f"  depth={depth}: {bw:.1f} GB/s", flush=True)
            best = max(best, bw)
        print(f"dma_deep: {best:.1f} GB/s = {best / SPEC_GBPS:.3f} of spec; "
              f"HIPLLAMA_ACHIEVABLE_BW={best * 1e9:.4e}", flush=True)
        return
    if a.mode == "wshape":
        for bn in (256, 512, 1024):
            bw = wshape_probe(gb=a.gb, reps=a.reps, bn=bn, device=dev)
            print(f"  wshape bn={bn}: {bw:.1f} GB/s", flush=True)
            print(f"  -> HIPLLAMA_ACHIEVABLE_BW={bw * 1e9:.4e}", flush=True)
        return
    if a.mode in ("dma", "copy"):
        ladder = [a.streams] if a.streams else [1, 2, 4, 8]
        best = 0.0
        for st in ladder:
            bw = dma_probe(gb=a.gb, copy=(a.mode == "copy"), reps=a.reps, streams=st,
                           block_kib=a.block_kib, device=dev)
            print(f"  streams={st}: {bw:.1f} GB/s", flush=True)
            best = max(best, bw)
        kind = "read" if a.mode == "dma" else "read+write copy"
        print(f"dma_{a.mode}: {best:.1f} GB/s bulk-copy {kind} "
              f"({a.reps} x {a.gb:.1f} GiB passes) = {best / SPEC_GBPS:.3f} of "
              f"the {SPEC_GBPS:.0f} GB/s spec sheet", flush=True)
        print("use as the port bench's achievable denominator: "
              f"HIPLLAMA_ACHIEVABLE_BW={best * 1e9:.3e}", flush=True)
        return
    vpu_main(device=dev)


if __name__ == "__main__":
    main()
