"""Where the greedy-epilogue kernel's time goes: time patched copies of
``csrc/greedy_epilogue.cu`` beside the production source on one card.

    python3 tools/greedy_variants.py

Each variant is the production source with one design choice changed by a
text patch (``variant_build``), built with ``nvcc`` into
``build/greedy_variants/`` and called through its C entry point at the
wrapper's plan (``greedy_cluster_plan``) unless a cluster or CTA size is
named:

* ``base``: the production kernel (16-byte register loads, 8 in flight a
  thread, the plan's CTA size, each rank's state pushed to rank 0);
* ``threads 256`` / ``threads 512``: the production kernel in CTAs of that
  size, whatever the plan picks;
* ``bulk``: the body read by 1-D TMA bulk copies (``cp.async.bulk``) into a
  ring of 4 x 16 KB shared-memory stages, each completing on its own
  mbarrier, in place of the register loads;
* ``loads 4``: 4 register loads in flight a thread;
* ``pull``: rank 0 reads every rank's state over distributed shared memory
  after a full cluster barrier, and a second one keeps the ranks resident
  (instead of each rank storing into rank 0 behind a barrier split around
  the loads);
* ``cluster 4`` / ``cluster 8``: the production kernel in smaller clusters.

Times are ``chip_smoke.timed_ms`` (device time, L2 flushed before each
call), the profiler span (``chip_smoke.device_us``) and
``chip_smoke.timed_after_ms`` (warm, right after the matmul that writes the
logits), f32, every variant at (8, 49152), (1, 49152), (8, 262144) and
(1, 262144); the two CTA sizes also at B 1, 2 and 4 of V 151936 and 262144
and at bf16 (1, 262144); ``base`` and ``bulk`` over a (512, 131072) f32
stream of 256 MB, with the rate each reaches.  Each variant is checked
against the plain version first.  The first line times an empty kernel
(``torch.cuda._sleep(1)``) the same way: the floor of the event method,
and its profiler span.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import variant_build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (timing helpers; puts src/ on the path)

BULK_HELPERS = ("// the cluster barrier in two halves", r'''constexpr int kStageBytes = 16384;      // one bulk copy
constexpr int kStages = 4;              // copies in flight a CTA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// that completes on `bar`, which expects exactly those bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the cluster barrier in two halves''')
REGISTER_READER = '''  const uint4* body = reinterpret_cast<const uint4*>(row + a0);
  for (int j0 = 0; j0 < n_vec; j0 += kLoads * kThreads) {
    uint4 r[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * kThreads + tid;
      if (j < n_vec) r[u] = __ldg(body + j);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * kThreads + tid;
      if (j < n_vec) push_vec<T>(s, r[u], a0 + j * kVec);
    }
  }
'''
BULK_READER = '''  extern __shared__ __align__(128) unsigned char ring[];   // kStages x kStageBytes
  __shared__ __align__(8) uint64_t full[kStages];
  constexpr int kStageVec = kStageBytes / 16;
  const int n_stages = (n_vec + kStageVec - 1) / kStageVec;
  const char* src = reinterpret_cast<const char*>(row + a0);
  auto copy_stage = [&](int k) {                             // stage k into slot k % kStages
    const int bytes = min(kStageVec, n_vec - k * kStageVec) * 16;
    bulk_copy(ring + (k % kStages) * kStageBytes, src + static_cast<size_t>(k) * kStageBytes,
              bytes, &full[k % kStages]);
  };
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&full[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    for (int k = 0; k < min(kStages, n_stages); ++k) copy_stage(k);
  }
  __syncthreads();                                           // the barriers are initialised
  for (int k = 0; k < n_stages; ++k) {
    mbar_wait(&full[k % kStages], (k / kStages) & 1);
    const uint4* st = reinterpret_cast<const uint4*>(ring + (k % kStages) * kStageBytes);
    const int nv = min(kStageVec, n_vec - k * kStageVec);
    for (int j = tid; j < nv; j += kThreads) push_vec<T>(s, st[j], a0 + (k * kStageVec + j) * kVec);
    if (k + kStages < n_stages) {                            // every thread is done with the slot
      __syncthreads();
      if (tid == 0) copy_stage(k + kStages);
    }
  }
'''
BULK = (BULK_HELPERS, (REGISTER_READER, BULK_READER),
        ("  cfg.stream = stream;\n  attr[0].id",
         "  cfg.stream = stream;\n  cfg.dynamicSmemBytes = kStages * kStageBytes;\n  attr[0].id"),
        ("""  return cudaFuncSetAttribute(greedy_epilogue_kernel<T, kThreads>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);""",
         """  const cudaError_t err = cudaFuncSetAttribute(
      greedy_epilogue_kernel<T, kThreads>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(greedy_epilogue_kernel<T, kThreads>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kStages * kStageBytes);"""))
PULL = (('''  cluster_wait();                    // every rank runs (long since, behind the loads)
  if (tid == 0) *cluster.map_shared_rank(&ranks[rank], 0) = s;     // push to rank 0
  cluster_arrive_release();
  cluster_wait();                    // every rank's state is in rank 0's shared memory
  if (rank == 0 && warp == 0) {
    s = lane < n_ranks ? ranks[lane] : empty_best();''',
         '''  if (tid == 0) ranks[0] = s;
  cluster_wait();
  cluster_arrive_release();
  cluster_wait();                    // every rank's ranks[0] is written
  if (rank == 0 && warp == 0) {
    s = lane < n_ranks ? *cluster.map_shared_rank(&ranks[0], lane) : empty_best();'''),
        ("      lp[blockIdx.y] = s.m - (s.m + logf(fmaxf(s.l, 1e-30f)));\n    }\n  }\n",
         "      lp[blockIdx.y] = s.m - (s.m + logf(fmaxf(s.l, 1e-30f)));\n    }\n  }\n"
         "  cluster_arrive_release();\n  cluster_wait();                    "
         "// rank 0 has read every rank\n"))
SOURCES = {"base": (), "bulk": BULK,
           "loads 4": (("constexpr int kLoads = 8;", "constexpr int kLoads = 4;"),),
           "pull": PULL}
# variant -> (source, cluster size or None for the plan's, CTA size or None for the plan's)
VARIANTS = {"base": ("base", None, None), "threads 256": ("base", None, 256),
            "threads 512": ("base", None, 512), "bulk": ("bulk", None, None),
            "loads 4": ("loads 4", None, None), "pull": ("pull", None, None),
            "cluster 4": ("base", 4, None), "cluster 8": ("base", 8, None)}
# (B, V, d_model of the matmul that writes the logits, dtype, variants)
F32, BF16 = "float32", "bfloat16"
ALL = tuple(VARIANTS)
SIZES = ("threads 256", "threads 512")
SHAPES = ((8, 49152, 576, F32, ALL), (1, 49152, 576, F32, ALL), (8, 262144, 2560, F32, ALL),
          (1, 262144, 2560, F32, ALL), (2, 262144, 2560, F32, SIZES),
          (4, 262144, 2560, F32, SIZES), (1, 151936, 2048, F32, SIZES),
          (2, 151936, 2048, F32, SIZES), (4, 151936, 2048, F32, SIZES),
          (1, 262144, 2560, BF16, SIZES))
STREAM = (512, 131072)                 # 256 MB of f32 logits


def build() -> dict:
    """nvcc of every patched source at once; name -> (greedy_epilogue entry,
    greedy_active_clusters entry) of its library."""
    libs = variant_build.build("greedy_variants", {
        name: variant_build.patched("greedy_epilogue", patches, name)
        for name, patches in SOURCES.items()})
    fns = {}
    for name, lib in libs.items():
        fn = lib.greedy_epilogue
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        lib.greedy_active_clusters.argtypes = [ctypes.c_int]
        lib.greedy_active_clusters.restype = ctypes.c_int
        fns[name] = (fn, lib.greedy_active_clusters)
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("greedy_variants: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.sampling import ops
    fns = build()
    log = chip_smoke.log
    log(f"[variants] {chip_smoke.card_line()}; torch {torch.__version__}")
    for name, (_, active) in fns.items():        # allows clusters of 16 in each library
        n = active(16)
        if n < 0:
            raise RuntimeError(f"{name}: cluster occupancy query failed: CUDA error {-n}")
        log(f"[variants] {name}: {n} clusters of 16 CTAs resident at once")
    dev = torch.device("cuda")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    empty = lambda: torch.cuda._sleep(1)                                # noqa: E731
    log(f"[variants] an empty kernel: {chip_smoke.timed_ms(empty, flush=flush):.4f} ms "
        f"(events), device time {chip_smoke.device_us(empty, flush=flush)}")
    sm, max_c = ops._sm_count(0), ops.greedy_max_cluster(0)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 95)

    def caller(name, x, tok, lp):
        src, cluster, threads = VARIANTS[name]
        B, V = x.shape
        C, width, plan_threads = ops.greedy_cluster_plan(B, V, sm, cluster or max_c,
                                                         x.element_size())
        threads = threads or plan_threads
        stream = torch.cuda.current_stream().cuda_stream
        code = int(x.dtype == torch.bfloat16)

        def call():
            # replint-torch: disable=KRN201 -- harness: its own inputs, no autograd
            err = fns[src][0](code, x.data_ptr(), x.stride(0), B, V, C, width, threads,
                              tok.data_ptr(), lp.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        tok_p, lp_p = ops.greedy_epilogue_plain(x)
        if not (torch.equal(tok, tok_p) and (lp - lp_p).abs().max().item() <= 1e-4):
            raise AssertionError(f"{name} {tuple(x.shape)} disagrees with the plain version")
        return call, f"clusters of {C} x {threads} threads"

    for B, V, d, dname, names in SHAPES:
        dt = getattr(torch, dname)
        x = (torch.randn((B, V), generator=g, device=dev) * 3.0).to(dt)
        h = torch.randn((B, d), generator=g, device=dev).to(dt)
        w = (torch.randn((d, V), generator=g, device=dev) * d ** -0.5).to(dt)
        tok = torch.empty((B,), dtype=torch.int32, device=dev)
        lp = torch.empty((B,), device=dev)
        for name in names:
            call, shape = caller(name, x, tok, lp)
            ms = chip_smoke.timed_ms(call, flush=flush)
            span = chip_smoke.device_us(call, flush=flush)
            warm = chip_smoke.timed_after_ms(lambda: torch.matmul(h, w, out=x), call)
            x.copy_((torch.randn((B, V), generator=g, device=dev) * 3.0).to(dt))
            log(f"[variants] ({B}, {V}) {dname} {name} ({shape}): flushed {ms:.4f} ms, warm "
                f"{warm:.4f} ms; {span}")
        del w

    x = torch.randn(STREAM, generator=g, device=dev)
    tok = torch.empty((STREAM[0],), dtype=torch.int32, device=dev)
    lp = torch.empty((STREAM[0],), device=dev)
    rates = []
    for name in ("base", "bulk"):
        call, shape = caller(name, x, tok, lp)
        ms = chip_smoke.timed_ms(call, flush=flush)
        rates.append(f"{name} ({shape}) {ms:.4f} ms, {x.numel() * 4 / ms / 1e9:.3f} TB/s")
    log(f"[variants] {STREAM} f32 stream of {x.numel() * 4 / 2**20:.0f} MB: " + "; ".join(rates))
    return 0


if __name__ == "__main__":
    sys.exit(main())
