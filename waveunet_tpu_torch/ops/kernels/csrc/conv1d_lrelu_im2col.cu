// Valid conv1d + bias + LeakyReLU for Hopper (sm_90a), channel-major, as one
// GEMM over the K*Cin contraction on the tensor cores (wgmma, 3xTF32).
//
// Replaces the TPU kernel waveunet_tpu/ops/pallas/conv1d_im2col.py::
// conv1d_lrelu_im2col:
//
//     y[b, o, t] = lrelu( sum_{k,c} W2[o, k*Cin + c] * x[b, c, t + k]
//                         + bias[o] )
//
// with x [B, Cin, L] (any batch, channel and time stride, so a decimated
// view x[:, :, ::2] needs no copy), W2[o, k*Cin + c] = w[k, c, o] from the
// TF-layout w [K, Cin, Cout], bias [Cout], y [B, Cout, L - K + 1]
// contiguous. The patch matrix P[t, k*Cin + c] = x[b, c, t + k] is never
// written anywhere: it exists only as shifted reads of a staged input slab,
// as the TPU kernel kept it in VMEM.
//
// What bounds it on this card: operations, on every layer but the first. A
// Wave-U-Net layer does 2*K*Cin FLOP per output value, hundreds of FLOP per
// byte of device memory. Parity with the JAX package needs fp32 accuracy;
// 3xTF32 gives it on the tensor cores: each operand is split into a = hi +
// lo, both rounded to TF32 (cvt.rna), and lo*hi + hi*lo + hi*hi is summed
// (lo*lo is below fp32's rounding). The least time is then 3 * FLOPs over
// 495 TFLOP/s (dense TF32 of an H100 SXM). The first layer (Cin = 2) is
// bound by the bytes of its 24-channel output.
//
// Design (wrapper: ops/kernels/conv1d_im2col.py, whose plan_launch makes the
// per-launch choices below in Python; the launcher re-checks them):
//  * GEMM with time on M and output channels on N: out-tile [t, o], M the
//    batch-flattened rows m = b * L_out + t, N = Cout, reduction K * Cin. A
//    block is one or two warpgroups, each computing 64 rows x tile_n
//    columns with one wgmma.mma_async m64n{tile_n}k8 .f32.tf32.tf32 per
//    product; tile_n is 24, 48, 72 or 96, chosen per launch (every
//    full_44KHz Cout is a multiple of 24). A (the patch matrix) comes from
//    registers: each thread reads its four A values of a k8 step from the
//    staged slab (the tap shift is an offset in that read) and splits them
//    into hi and lo in registers. B (the weights, K-major as tf32 wgmma
//    requires) comes from shared memory.
//  * Weights are prepared once per call by a small kernel
//    (prep_weights_kernel): split into TF32 hi and lo and written, per
//    column tile and reduction chunk, in exactly the order and layout the
//    block's shared memory holds them ([r / 4][n][4]: 8 x 16-byte core
//    matrices, no swizzle, LBO = tile_n * 16 bytes along the reduction, SBO
//    = 128 bytes along N). One cp.async.bulk (the TMA engine's bulk copy)
//    per chunk then moves them into the ring, completing on an mbarrier.
//  * Reduction chunks: 8 input channels x a group of taps (the row of a k8
//    step is one tap of 8 channels), the K taps cut into as few equal
//    groups as keep a stage's hi and lo weights within 56 KB; or, for thin
//    inputs (Cin <= 4), one chunk over the flat K * Cin patch row padded to
//    a multiple of 8 (30 -> 32 for the first layer) instead of 8-channel
//    chunks that are mostly zeros.
//  * A 2-stage ring in dynamic shared memory: chunk i + 1's weights (bulk
//    copy) and input slab (4-byte cp.async, zero-filled outside the input,
//    any strides; every full_44KHz row length is odd, so no wider copy is
//    aligned) are in flight while chunk i is multiplied. The slab holds the
//    block's rows plus K - 1 halo rows for each batch row they touch; a
//    table in shared memory maps each slab row to its input row, so deep
//    layers (L_out down to 21) fill 128-row tiles across batch rows. Slab
//    rows are padded to 8 mod 32 floats: the A reads are free of bank
//    conflicts.
//  * Occupancy: launch bounds of two 256-thread blocks an SM (128
//    registers a thread; tile_n 96 spills a few bytes under that cap) and
//    shared memory under half an SM. On the H100 the instantiations that
//    ran one block an SM, or that staged fewer taps per chunk in three
//    stages, were the slowest over the full_44KHz shapes.
//  * fp32 accuracy: the tensor cores' fp32 accumulation truncates. The
//    three products of every two k8 steps (16 reduction rows) go into fresh
//    accumulators (scale-d = 0 on the first), the small terms of both steps
//    before their hi*hi terms, and the CUDA cores then add the fresh sums
//    to fp32 totals; the kernel then stays as close to an fp64 evaluation
//    as the plain fp32 version.
//  * Split-K where the tiles fill under 3/4 of one wave of resident blocks
//    (the deep layers): blocks along grid y take equal runs of the chunks
//    and write fp32 partials to a workspace in y's layout; a second kernel
//    sums them in split order and applies bias and LeakyReLU. No atomics:
//    repeated runs give the same bits.
//  * Epilogue: bias and LeakyReLU in registers; the [t, o] tile is stored
//    channel-major straight from the accumulators (eight threads of a
//    warp write eight consecutive time steps of one channel: whole 32-byte
//    sectors).
// Warp specialisation, a persistent grid and TMA for the input slab (no
// tensor map fits rows of odd length) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WG_ROWS = 64;     // rows of one warpgroup's wgmma tile
constexpr int CHUNK = 8;        // input channels of a (non-flat) chunk
constexpr int FLAT_MAX_CIN = 4; // thin inputs reduced over the flat row
constexpr int STAGES = 2;       // ring depth
constexpr int GROUP = 2;        // k8 steps per fresh accumulator
constexpr int K_MAX = 16;       // widest filter
constexpr int TAIL = 8;         // zero slab rows past the flat row's reads
constexpr int MAX_SMEM = 232448;
constexpr float ALPHA = 0.2f;   // LeakyReLU slope of every Wave-U-Net

struct Params {
  const float* x;
  const float* wp;        // prepared weights (prep_weights_kernel)
  const float* bias;
  float* y;
  float* ws;              // split partials [splits][B][Cout][L_out], or null
  long long x_sb, x_sc, x_st;  // strides of x, in floats
  int B, L_out, L_in, Cin, Cout, K, M;
  int tile_m, n_tiles;
  int flat;               // one chunk over the flat K*Cin patch row
  int taps;               // taps per chunk (K when flat)
  int tap_groups;         // chunks per 8-channel group (1 when flat)
  int chunk_r;            // reduction rows of a chunk, a multiple of 8
  int chunks, per_split;
  int slab_rows, row;     // slab rows, and floats per slab channel row
  int table_bytes;        // the row-offset table ahead of the barriers
  int w_floats;           // weights of one stage: 2 * chunk_r * tile_n
  int stage_floats;       // w_floats + CHUNK * row
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 bytes; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One thread: expect `bytes` on the barrier and bulk-copy them (TMA engine)
// from global src into shared dst; both 16-byte aligned, bytes % 16 == 0.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a = hi + lo, both rounded to TF32 as cvt.rna rounds.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  const float rest = a - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// wgmma shared-memory descriptor of a K-major, no-swizzle operand: start
// address, leading byte offset (between core matrices along the reduction)
// and stride byte offset (between 8-row groups along N), all >> 4.
__device__ __forceinline__ uint64_t make_desc(const float* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers are in flight until the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= a * b: one m64n24k8 TF32 product, A from registers, B from
// shared memory; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_n24(float (&d)[12],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (+)= a * b: one m64n48k8 TF32 product, A from registers, B from
// shared memory; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_n48(float (&d)[24],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (+)= a * b: one m64n72k8 TF32 product (see wgmma_n24).
__device__ __forceinline__ void wgmma_n72(float (&d)[36],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (+)= a * b: one m64n96k8 TF32 product (see wgmma_n24).
__device__ __forceinline__ void wgmma_n96(float (&d)[48],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (BN == 24)
    wgmma_n24(d, a, desc, scale_d);
  else if constexpr (BN == 48)
    wgmma_n48(d, a, desc, scale_d);
  else if constexpr (BN == 72)
    wgmma_n72(d, a, desc, scale_d);
  else
    wgmma_n96(d, a, desc, scale_d);
}

// Reduction row q of chunk ch -> (tap k, input channel c). A non-flat chunk
// is 8 channels x `taps` taps, row q = (k - tap0) * 8 + (c - c0); a flat
// chunk is the patch row itself, q = k * Cin + c (rows past K * Cin are
// padding and carry zero weights).
__device__ __forceinline__ void chunk_row(const Params& p, int ch, int q,
                                          int& k, int& c) {
  if (p.flat) {
    k = q / p.Cin;
    c = q - k * p.Cin;
  } else {
    c = (ch / p.tap_groups) * CHUNK + (q & (CHUNK - 1));
    k = (ch % p.tap_groups) * p.taps + (q >> 3);
  }
}

// The weights split into TF32 hi and lo, in the layout and order the ring
// holds them: wp[n_tile][chunk][hi, lo][q / 4][n][q % 4] = W2[n_tile *
// tile_n + n, row q of the chunk], zero past Cout, Cin and K.
__global__ void __launch_bounds__(256)
prep_weights_kernel(const Params p, const float* __restrict__ w,
                    float* __restrict__ wp, int tile_n, long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long rest = i / 4;
    const int n = (int)(rest % tile_n);
    rest /= tile_n;
    const int q = (int)(rest % (p.chunk_r / 4)) * 4 + (int)(i % 4);
    rest /= p.chunk_r / 4;
    const int half = (int)(rest % 2);
    rest /= 2;
    const int ch = (int)(rest % p.chunks);
    const int o = (int)(rest / p.chunks) * tile_n + n;
    int k, c;
    chunk_row(p, ch, q, k, c);
    float v = 0.f;
    if (o < p.Cout && k < p.K && c < p.Cin)
      v = w[((long long)k * p.Cin + c) * p.Cout + o];
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    wp[i] = __uint_as_float(half ? lo : hi);
  }
}

// Stage chunk ch into one ring slot: its weights by one bulk copy (thread
// 0), its input slab [8 channels][row] by 4-byte cp.async from every
// thread; channels past Cin and table rows of -1 are zero-filled.
__device__ __forceinline__ void load_chunk(const Params& p,
                                           const long long* table,
                                           float* stage, uint64_t* bar,
                                           int ch, int n_tile, int tid,
                                           int nthreads) {
  if (tid == 0)
    bulk_load(stage, p.wp + ((long long)n_tile * p.chunks + ch) * p.w_floats,
              4 * p.w_floats, bar);
  float* xs = stage + p.w_floats;
  const int c0 = p.flat ? 0 : (ch / p.tap_groups) * CHUNK;
  const int n = CHUNK * p.slab_rows;
  for (int i = tid; i < n; i += nthreads) {
    const int c = i / p.slab_rows;
    const int s = i - c * p.slab_rows;
    const long long off = table[s];
    const bool ok = off >= 0 && c0 + c < p.Cin;
    const float* src = ok ? p.x + off + (long long)(c0 + c) * p.x_sc : p.x;
    cp_async4(xs + c * p.row + s, src, ok ? 4 : 0);
  }
}

// One group of up to GROUP k8 steps (j0, j0 + 1, ...) of a staged chunk:
// read and split this thread's A values, then start the 3xTF32 products of
// every step into the fresh accumulators d (the first with scale-d = 0) and
// commit them as one wgmma group. The caller waits for it.
template <int BN>
__device__ __forceinline__ void mma_group(
    float (&d)[BN / 2], const Params& p, const float* xs, const float* w_hi,
    const float* w_lo, int ch, int tap0, int j0, int ns, int tq,
    const int (&s_row)[2]) {
  // A fragments: a[0] = (row g, col tq), a[1] = (g + 8, tq),
  // a[2] = (g, tq + 4), a[3] = (g + 8, tq + 4) of each k8 step.
  uint32_t ah[GROUP][4], al[GROUP][4];
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    if (u < ns) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // slab offset of reduction column tq + 4 * half: channel tq +
        // 4 * half at tap tap0 + j of a chunk, or (q % Cin, q / Cin) of a
        // flat row
        const int j = j0 + u;
        int off;
        if (p.flat) {
          int k, c;
          chunk_row(p, ch, 8 * j + tq + 4 * half, k, c);
          off = c * p.row + k;
        } else {
          off = (tq + 4 * half) * p.row + tap0 + j;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_tf32(xs[off + s_row[h]], ah[u][2 * half + h],
                     al[u][2 * half + h]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    fence_regs(ah[u]);
    fence_regs(al[u]);
  }
  fence_regs(d);
  wgmma_fence();
  // Step j's B is core-matrix columns 2j and 2j + 1 of the stage's hi and
  // lo blocks. The small terms of every step (lo*hi, hi*lo) go first and
  // the hi*hi terms last: the tensor cores truncate each sum to the
  // accumulator's magnitude, and this order makes one truncation a step at
  // the large magnitude instead of up to three.
  constexpr int LBO = 16 * BN;  // bytes between core matrices along r
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    if (u < ns) {
      const int j = j0 + u;
      wgmma_tf32<BN>(d, al[u], make_desc(w_hi + 8 * BN * j, LBO, 128),
                     u > 0);
      wgmma_tf32<BN>(d, ah[u], make_desc(w_lo + 8 * BN * j, LBO, 128), 1);
    }
  }
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    if (u < ns)
      wgmma_tf32<BN>(d, ah[u],
                     make_desc(w_hi + 8 * BN * (j0 + u), LBO, 128), 1);
  }
  wgmma_commit();
}

// One block: tile_m (64 or 128) flattened rows x BN columns over one
// split's run of reduction chunks; one warpgroup per 64 rows.
template <int BN>
__global__ void __launch_bounds__(256, 2)
im2col_wgmma_kernel(const Params p) {
  constexpr int ND = BN / 2;  // accumulators of a thread
  extern __shared__ __align__(128) unsigned char smem[];
  long long* table = reinterpret_cast<long long*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.table_bytes);
  float* ring = reinterpret_cast<float*>(smem + p.table_bytes + 128);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int m_tile = blockIdx.x / p.n_tiles;
  const int n_tile = blockIdx.x - m_tile * p.n_tiles;
  const int n0 = n_tile * BN;
  const int m0 = m_tile * p.tile_m;
  const int rows = min(p.tile_m, p.M - m0);
  const int split = blockIdx.y;
  const int c_first = split * p.per_split;
  const int nk = min(p.chunks - c_first, p.per_split);
  const int b0 = m0 / p.L_out;
  const int t0 = m0 - b0 * p.L_out;
  const int halo = p.K - 1;

  // Slab row -> offset of its input time step in x (-1: zero row). The
  // first batch row's segment starts at t0; each later one at t = 0 and
  // spans L_in rows (its outputs and their halo), the last one cut short.
  {
    const int seg0 = min(p.L_out - t0, rows) + halo;
    const int b_last = (m0 + rows - 1) / p.L_out;
    const int valid = rows + halo * (b_last - b0 + 1);
    for (int s = tid; s < p.slab_rows; s += nthreads) {
      long long off = -1;
      if (s < valid) {
        int b, t;
        if (s < seg0) {
          b = b0;
          t = t0 + s;
        } else {
          const int j = (s - seg0) / p.L_in;
          b = b0 + 1 + j;
          t = s - seg0 - j * p.L_in;
        }
        off = (long long)b * p.x_sb + (long long)t * p.x_st;
      }
      table[s] = off;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // This thread's two rows (g and g + 8 of its warp's 16) and their slab
  // positions; rows past the tile read slab row 0 and are not stored.
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lr0 = (warp >> 2) * WG_ROWS + (warp & 3) * 16 + g;
  int s_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = lr0 + 8 * h;
    s_row[h] = lr < rows ? lr + halo * ((m0 + lr) / p.L_out - b0) : 0;
  }

  float acc[ND], d[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = d[i] = 0.f;

  __syncthreads();  // the table and the barriers are ready
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_chunk(p, table, ring + st * p.stage_floats, &full[st],
                 c_first + st, n_tile, tid, nthreads);
    cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    const int slot = it % STAGES;
    cp_async_wait<STAGES - 2>();
    mbar_wait(&full[slot], (it / STAGES) & 1);
    __syncthreads();  // chunk it has landed; slot (it - 1) % STAGES is free
    {
      const int nxt = it + STAGES - 1;
      if (nxt < nk)
        load_chunk(p, table, ring + (nxt % STAGES) * p.stage_floats,
                   &full[nxt % STAGES], c_first + nxt, n_tile, tid, nthreads);
      cp_async_commit();
    }
    const float* w_hi = ring + slot * p.stage_floats;
    const float* w_lo = w_hi + p.chunk_r * BN;
    const float* xs = w_hi + p.w_floats;
    const int ch = c_first + it;
    const int tap0 = p.flat ? 0 : (ch % p.tap_groups) * p.taps;
    const int steps = p.flat ? p.chunk_r / 8 : min(p.taps, p.K - tap0);
    for (int j0 = 0; j0 < steps; j0 += GROUP) {
      mma_group<BN>(d, p, xs, w_hi, w_lo, ch, tap0, j0,
                    min(GROUP, steps - j0), tq, s_row);
      wgmma_wait_all();
      fence_regs(d);
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] += d[i];
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator 4j + 2h + e is (row g + 8h, column 8j + 2tq + e).
  const long long plane = (long long)p.Cout * p.L_out;
  float* out = p.ws ? p.ws + (long long)split * p.B * plane : p.y;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = lr0 + 8 * h;
    if (lr >= rows) continue;
    const int m = m0 + lr;
    const int b = m / p.L_out;
    float* yr = out + (long long)b * plane + (m - b * p.L_out);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * tq + e;
        if (n >= p.Cout) continue;
        float v = acc[4 * j + 2 * h + e];
        if (!p.ws) {
          v += p.bias[n];
          v = fmaxf(ALPHA * v, v);
        }
        yr[(long long)n * p.L_out] = v;
      }
  }
}

// y = lrelu(sum of the split partials in split order + bias); y and each
// partial are [B][Cout][L_out].
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws,
                     const float* __restrict__ bias, float* __restrict__ y,
                     long long total, int Cout, int L_out, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s += ws[k * total + i];
    const float v = s + bias[(i / L_out) % Cout];
    y[i] = fmaxf(ALPHA * v, v);
  }
}

template <int BN>
cudaError_t launch(const Params& p, int splits, int smem, cudaStream_t stream) {
  // The opt-in limit above 48 KB, raised on demand, per card.
  static int smem_set[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > smem_set[dev])) {
    e = cudaFuncSetAttribute(im2col_wgmma_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set[dev] = smem;
  }
  const dim3 grid((unsigned)((long long)((p.M + p.tile_m - 1) / p.tile_m) *
                             p.n_tiles),
                  splits);
  im2col_wgmma_kernel<BN>
      <<<grid, 2 * p.tile_m, smem, stream>>>(p);  // 128 threads a warpgroup
  return cudaGetLastError();
}

}  // namespace

// Launcher with a plain C interface (bound with ctypes). Pointers are device
// pointers; strides are in elements; the launches go on `stream` and do not
// synchronise. The plan (tile_m, tile_n, flat, taps per chunk, splits,
// chunks per split, slab rows, slab row stride, shared memory) comes from the
// wrapper's plan_launch (ops/kernels/conv1d_im2col.py). wp is scratch of
// n_tiles * chunks * 2 * chunk_r * tile_n floats for the prepared weights;
// ws holds splits * B * Cout * L_out floats when splits > 1 and may be null
// otherwise. Three launches: the weight preparation, the GEMM, and the sum
// of the split partials when splits > 1. Returns cudaGetLastError() of the
// last launch (0 when accepted), or cudaErrorInvalidValue for a plan or shape
// outside the kernel's limits: K <= 16, tile_m 64 or 128, tile_n 24 to 96,
// a flat chunk only for Cin <= 4, a slab that holds the tile's rows, halo
// and tail, a slab row stride of 8 mod 32 floats, shared memory within the
// block's limit, a split that covers the chunks, the grid's extents.
extern "C" int conv1d_lrelu_im2col_f32(
    const float* x, const float* w, const float* bias, float* y, float* wp,
    float* ws, int B, int L_out, int Cin, int Cout, int K, long long x_sb,
    long long x_sc, long long x_st, int tile_m, int tile_n, int flat,
    int taps, int splits, int per_split, int slab_rows, int row, int smem,
    cudaStream_t stream) {
  const long long M = (long long)B * L_out;
  if (K < 1 || K > K_MAX || B < 1 || L_out < 1 || Cin < 1 || Cout < 1 ||
      M >= (1LL << 31) || (tile_m != WG_ROWS && tile_m != 2 * WG_ROWS) ||
      (tile_n != 24 && tile_n != 48 && tile_n != 72 && tile_n != 96) || splits < 1 || splits > 65535 ||
      per_split < 1 || wp == nullptr || (splits > 1 && ws == nullptr) ||
      (flat && Cin > FLAT_MAX_CIN))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.wp = wp;
  p.bias = bias;
  p.y = y;
  p.ws = splits > 1 ? ws : nullptr;
  p.x_sb = x_sb;
  p.x_sc = x_sc;
  p.x_st = x_st;
  p.B = B;
  p.L_out = L_out;
  p.L_in = L_out + K - 1;
  p.Cin = Cin;
  p.Cout = Cout;
  p.K = K;
  p.M = (int)M;
  p.tile_m = tile_m;
  p.n_tiles = (Cout + tile_n - 1) / tile_n;
  p.flat = flat;
  if (flat) {
    p.taps = K;
    p.tap_groups = 1;
    p.chunk_r = (K * Cin + 7) / 8 * 8;
    p.chunks = 1;
  } else {
    if (taps < 1 || taps > K) return (int)cudaErrorInvalidValue;
    p.taps = taps;
    p.tap_groups = (K + taps - 1) / taps;
    p.chunk_r = CHUNK * taps;
    p.chunks = (Cin + CHUNK - 1) / CHUNK * p.tap_groups;
  }
  p.per_split = per_split;
  if ((long long)splits * per_split < p.chunks ||
      (long long)(splits - 1) * per_split >= p.chunks)
    return (int)cudaErrorInvalidValue;
  // The slab must hold the tile's rows, K - 1 halo rows for each batch row
  // they touch, and the tail the flat chunk's padded rows read.
  const long long nb =
      tile_m < 2 ? 1 : std::min<long long>(B, (tile_m - 2) / L_out + 2);
  if (slab_rows < tile_m + (K - 1) * nb + TAIL || row < slab_rows ||
      row % 32 != 8)
    return (int)cudaErrorInvalidValue;
  p.slab_rows = slab_rows;
  p.row = row;
  p.table_bytes = (slab_rows * 8 + 15) / 16 * 16;
  p.w_floats = 2 * p.chunk_r * tile_n;
  p.stage_floats = p.w_floats + CHUNK * row;
  const long long need =
      p.table_bytes + 128 + (long long)STAGES * 4 * p.stage_floats;
  if (smem < need || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long grid_x = (M + tile_m - 1) / tile_m * (long long)p.n_tiles;
  if (grid_x >= (1LL << 31)) return (int)cudaErrorInvalidValue;

  const long long prep = (long long)p.n_tiles * p.chunks * p.w_floats;
  prep_weights_kernel<<<(int)std::min<long long>((prep + 255) / 256,
                                                 132 * 16),
                        256, 0, stream>>>(p, w, wp, tile_n, prep);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (tile_n == 24)
    e = launch<24>(p, splits, smem, stream);
  else if (tile_n == 48)
    e = launch<48>(p, splits, smem, stream);
  else if (tile_n == 72)
    e = launch<72>(p, splits, smem, stream);
  else
    e = launch<96>(p, splits, smem, stream);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long total = M * Cout;
  splitk_reduce_kernel<<<(int)std::min<long long>((total + 255) / 256,
                                                  132 * 16),
                         256, 0, stream>>>(ws, bias, y, total, Cout, L_out,
                                           splits);
  return (int)cudaGetLastError();
}
