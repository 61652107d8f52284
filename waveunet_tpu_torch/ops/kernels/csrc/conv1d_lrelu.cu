// Valid conv1d + bias + LeakyReLU for Hopper (sm_90a), fp32-accurate on the
// tensor cores (3xTF32).
//
// Replaces the TPU kernel waveunet_tpu/ops/pallas/conv1d_fused.py::
// conv1d_lrelu_pallas:
//
//     y[b, t, o] = lrelu( sum_k sum_c x[b, t + k, c] * w[k, c, o] + bias[o] )
//
// with x [B, L, Cin] (channel stride 1, any batch and time stride, so a
// decimated view x[:, ::2, :] needs no copy), w [K, Cin, Cout] in the TF
// layout, bias [Cout], y [B, L - K + 1, Cout] contiguous.
//
// What bounds it: operations, on every Wave-U-Net layer but the first. A
// layer does 2*K*Cin FLOP per output value, hundreds of FLOP per byte of
// device memory. Parity with the JAX package needs fp32 accuracy; 3xTF32
// gives it on the tensor cores: each operand is split into a = hi + lo, both
// rounded to TF32 (cvt.rna), and hi*hi + hi*lo + lo*hi is accumulated in
// fp32 (lo*lo is below fp32's rounding). Three TF32 products per fp32
// product make the least time 3 * FLOPs over 495 TFLOP/s (dense TF32 of an
// H100 SXM). The first layer (Cin = 2) is bound by the bytes of its
// 24-channel output.
//
// Design (wrapper: ops/kernels/conv1d_fused.py, whose plan_launch makes the
// per-launch choices below in Python):
//  * Implicit GEMM with batch-flattened rows: M = B * L_out, N = Cout,
//    reduction K * Cin. A block computes up to 128 rows (b, t) = (m / L_out,
//    m % L_out) of one column tile, across batch rows, so the deep layers
//    (L_out 21 to 69 at the bottleneck) no longer pad each batch row to a
//    128-row tile. Its input slab for one chunk of the reduction holds the
//    tile's rows plus K - 1 halo rows for each batch row it touches: tile
//    row m reads slab row (m - m0) + (K - 1) * (b(m) - b(m0)), plus k for
//    tap k. A table in shared memory maps each slab row to its input row.
//  * Column tiles of 24 or 48 (one or two warp columns of 24), chosen per
//    launch: the widest whose padded columns stay under 1/8, so every
//    full_44KHz Cout (a multiple of 24) pads under 1/8; other widths are
//    masked. Tiles of 72 and 96 were slower than 24 or 48 over the
//    full_44KHz layers on the H100: a block of 6 or 8 warps holds a whole
//    SM alone, where blocks of 2 or 4 warps share it.
//  * Tensor cores: mma.sync m16n8k8 TF32. Each warp holds a 64 x 24 tile
//    (4 x 3 fragments, 48 fp32 accumulators a thread) and splits every A
//    and B fragment it loads into hi and lo in registers, so the weights
//    and the wrapper stay fp32. The 8 reduction lanes of a fragment are
//    permuted (lane t reads reduction rows 2t and 2t+1), so a thread's two
//    A values of one row are one 8-byte shared load; slab rows of 8 floats
//    and weight rows of tile_n + 4 floats make the fragment loads free of
//    bank conflicts. The tensor cores' fp32 accumulation truncates, so the
//    products of every two k8 steps go into fresh fragments that are added
//    to the fp32 accumulators on the CUDA cores. Accumulating into the
//    running total drifted far past fp32 rounding on the long reductions
//    (K * Cin up to 3000); with the fresh fragments the kernel stays as
//    close to an fp64 reference as the plain version's cuBLAS fp32.
//    Launch bounds hold a thread to 170 registers: 12 warps an SM.
//  * Bias and LeakyReLU in the epilogue: the pre-activation never reaches
//    device memory, except as split partials.
//  * Split-K where the M x N tiles fill under 3/4 of one wave of resident
//    blocks (the deep layers at B = 16, most layers at B = 1): blocks along
//    grid y take equal runs of the reduction chunks and write fp32 partials
//    to a workspace; a second kernel sums them in a fixed order and applies
//    bias and LeakyReLU. No atomics: repeated runs give the same bits.
//  * A 2-stage cp.async ring in dynamic shared memory: the slab and the
//    [K*8, tile_n] weight slice of chunk i + 1 are in flight while chunk i
//    is multiplied (a third stage was slower on the H100: it halves the
//    blocks an SM holds at K = 15). 16-byte copies where rows are 16-byte
//    aligned (Cin % 4 == 0, strides and base aligned: every full_44KHz layer
//    but the first), 8- or 4-byte copies otherwise; absent channels are
//    zero-filled by the copy.
//  * Thin inputs (Cin 2, 4 or 6, rows back to back): the patch row of an
//    output is K * Cin contiguous floats, so the block reduces over that
//    flat row, padded to a multiple of 8 (30 -> 32 for the first layer),
//    instead of 8-channel chunks that are mostly zeros.
// wgmma, TMA and warp specialisation are the next redesign's work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TILE_M = 128;    // rows of a block: 2 warp rows of 64
constexpr int WARP_N = 24;     // columns of a warp: 3 n8 fragments
constexpr int MF = 4;          // m16 fragments of a warp
constexpr int NF = 3;          // n8 fragments of a warp
constexpr int CHUNK = 8;       // input channels per reduction chunk
constexpr int STAGES = 2;      // cp.async ring depth
constexpr int K_MAX = 16;      // widest filter
constexpr int MAX_SMEM = 232448;
constexpr float ALPHA = 0.2f;  // LeakyReLU slope of every Wave-U-Net

struct Params {
  const float* x;
  const float* w;
  const float* bias;
  float* y;
  float* ws;             // split partials [splits][M][Cout], or null
  long long x_sb, x_st;  // batch and time strides of x, in floats
  int L_out, L_in, Cin, Cout, K, M;
  int tile_m, n_tiles;
  int flat;              // one chunk over the flat K*Cin patch row
  int lda;               // floats per slab row (CHUNK, or Cin when flat)
  int chunk_r;           // reduction length of a chunk, a multiple of 8
  int chunks, per_split;
  int slab_rows, slab_floats;  // per stage; slab_floats % 4 == 0
  int table_bytes;       // the row-offset table ahead of the ring
  int x_vec, w_vec;      // floats per cp.async of x (4, 2, 1) and w (4, 1)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of N bytes; src_bytes = 0 zero-fills the destination.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = hi + lo, both rounded to TF32 as cvt.rna rounds.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  const float rest = a - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a * b on the tensor cores (m16n8k8, TF32 in, fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b on the tensor cores, starting from zero.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// The slab of one chunk: slab_rows x lda floats, V floats a copy. Channels
// at or past Cin and rows outside the tile's inputs are zero-filled.
template <int V>
__device__ __forceinline__ void load_slab(const Params& p,
                                          const long long* table, float* xs,
                                          int c0, int tid, int nthreads) {
  const int per_row = p.lda / V;
  const int n = p.slab_rows * per_row;
  for (int i = tid; i < n; i += nthreads) {
    const int s = i / per_row;
    const int q = (i - s * per_row) * V;
    const long long off = table[s];
    const bool ok = off >= 0 && c0 + q < p.Cin;
    const float* src = ok ? p.x + off + c0 + q : p.x;
    cp_async<4 * V>(xs + s * p.lda + q, src, ok ? 4 * V : 0);
  }
}

// The weights of one chunk: chunk_r rows x BN columns at a row stride of
// BN + 4 floats. Row r is w[k, c0 + c] with r = k * 8 + c, or the flat row
// r = k * Cin + c of a flat chunk; absent rows and columns are zero-filled.
template <int BN, int V>
__device__ __forceinline__ void load_weights(const Params& p, float* wsm,
                                             int c0, int n0, int tid,
                                             int nthreads) {
  constexpr int LDB = BN + 4;
  constexpr int PER_ROW = BN / V;
  const int n = p.chunk_r * PER_ROW;
  const int flat_r = p.K * p.Cin;
  for (int i = tid; i < n; i += nthreads) {
    const int r = i / PER_ROW;
    const int q = (i - r * PER_ROW) * V;
    int gr;
    bool ok;
    if (p.flat) {
      gr = r;
      ok = r < flat_r;
    } else {
      const int c = c0 + (r & (CHUNK - 1));
      gr = (r >> 3) * p.Cin + c;
      ok = c < p.Cin;
    }
    const int col = n0 + q;
    ok = ok && col < p.Cout;
    const float* src = ok ? p.w + (long long)gr * p.Cout + col : p.w;
    cp_async<4 * V>(wsm + r * LDB + q, src, ok ? 4 * V : 0);
  }
}

template <int BN>
__device__ __forceinline__ void load_chunk(const Params& p,
                                           const long long* table, float* st,
                                           int chunk, int n0, int tid) {
  constexpr int THREADS = 64 * (BN / WARP_N);
  const int c0 = p.flat ? 0 : chunk * CHUNK;
  if (p.x_vec == 4)
    load_slab<4>(p, table, st, c0, tid, THREADS);
  else if (p.x_vec == 2)
    load_slab<2>(p, table, st, c0, tid, THREADS);
  else
    load_slab<1>(p, table, st, c0, tid, THREADS);
  float* wsm = st + p.slab_floats;
  if (p.w_vec == 4)
    load_weights<BN, 4>(p, wsm, c0, n0, tid, THREADS);
  else
    load_weights<BN, 1>(p, wsm, c0, n0, tid, THREADS);
}

// One block: up to tile_m flattened rows x BN columns over one split's run
// of reduction chunks. Warps are 2 (rows) x BN / 24 (columns).
template <int BN>
__global__ void __launch_bounds__(64 * (BN / WARP_N), 6 / (BN / WARP_N))
conv1d_lrelu_tc_kernel(const Params p) {
  constexpr int THREADS = 64 * (BN / WARP_N);
  constexpr int LDB = BN + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* table = reinterpret_cast<long long*>(smem);
  float* ring = reinterpret_cast<float*>(smem + p.table_bytes);
  const int stage_floats = p.slab_floats + p.chunk_r * LDB;

  const int tid = threadIdx.x;
  const int m_tile = blockIdx.x / p.n_tiles;
  const int n0 = (blockIdx.x - m_tile * p.n_tiles) * BN;
  const int m0 = m_tile * p.tile_m;
  const int rows = min(p.tile_m, p.M - m0);
  const int split = blockIdx.y;
  const int c_first = split * p.per_split;
  const int nk = min(p.chunks - c_first, p.per_split);
  const int b0 = m0 / p.L_out;
  const int t0 = m0 - b0 * p.L_out;
  const int halo = p.K - 1;

  // Slab row -> offset of its input row in x (-1: zero row). The first
  // batch row's segment starts at t0; each later one at t = 0 and spans
  // L_in rows (its outputs and their halo), the last one cut short.
  {
    const int seg0 = min(p.L_out - t0, rows) + halo;
    const int b_last = (m0 + rows - 1) / p.L_out;
    const int valid = rows + halo * (b_last - b0 + 1);
    for (int s = tid; s < p.slab_rows; s += THREADS) {
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

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;

  // Slab offsets (in floats) of this thread's 8 A rows: fragment f, half h
  // (rows g and g + 8). Rows past the tile read slab row 0 and are not
  // stored.
  int a_off[MF][2];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm * 64 + f * 16 + h * 8 + g;
      int s = 0;
      if (lr < rows) s = lr + halo * ((m0 + lr) / p.L_out - b0);
      a_off[f][h] = s * p.lda + 2 * tq;
    }

  float acc[MF][NF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  __syncthreads();  // the table is complete
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_chunk<BN>(p, table, ring + st * stage_floats, c_first + st, n0,
                     tid);
    cp_async_commit();
  }

  const int b_col = wn * WARP_N + g;
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk it has landed; slot (it - 1) % STAGES is free
    {
      const int nxt = it + STAGES - 1;
      if (nxt < nk)
        load_chunk<BN>(p, table, ring + (nxt % STAGES) * stage_floats,
                       c_first + nxt, n0, tid);
      cp_async_commit();
    }
    const float* xs = ring + (it % STAGES) * stage_floats;
    const float* wsm = xs + p.slab_floats + 2 * tq * LDB + b_col;
    // Two k8 steps at a time: their 3xTF32 products (a_lo*b_hi, a_hi*b_lo,
    // a_hi*b_hi, small terms first) go into fresh fragments d, which are
    // then added to acc on the CUDA cores. The tensor cores' fp32
    // accumulation truncates; against d, the sum of 16 products, that
    // costs a fraction of an ulp of d, where against the running total it
    // would cost a biased part of an ulp of the total at every product.
    for (int r0 = 0; r0 < p.chunk_r; r0 += 16) {
      float d[MF][NF][4];
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        const int r = r0 + 8 * step;
        if (step == 1 && r >= p.chunk_r) break;
        // A fragment: a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4),
        // a[3] = (g + 8, t + 4); reduction lane t is row 2t, t + 4 is
        // 2t + 1: one 8-byte load.
        uint32_t ah[MF][4], al[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v =
                *reinterpret_cast<const float2*>(xs + a_off[f][h] + r);
            split_tf32(v.x, ah[f][h], al[f][h]);
            split_tf32(v.y, ah[f][2 + h], al[f][2 + h]);
          }
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          // B fragment: b[0] = (k t, n g), b[1] = (k t + 4, n g)
          const float* wp = wsm + r * LDB + j * 8;
          uint32_t bh[2], bl[2];
          split_tf32(wp[0], bh[0], bl[0]);
          split_tf32(wp[LDB], bh[1], bl[1]);
#pragma unroll
          for (int f = 0; f < MF; ++f) {
            if (step == 0)
              mma_tf32_first(d[f][j], al[f], bh);
            else
              mma_tf32(d[f][j], al[f], bh);
            mma_tf32(d[f][j], ah[f], bl);
            mma_tf32(d[f][j], ah[f], bh);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][j][e] += d[f][j][e];
    }
  }
  cp_async_wait<0>();

  // Epilogue: C fragment c[2h + e] = (row g + 8h, column 2t + e).
  const bool pair = (p.Cout & 1) == 0;
  float* out = p.ws ? p.ws + (long long)split * p.M * p.Cout : p.y;
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm * 64 + f * 16 + h * 8 + g;
      if (lr >= rows) continue;
      float* row = out + (long long)(m0 + lr) * p.Cout;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int n = n0 + wn * WARP_N + j * 8 + 2 * tq;
        if (n >= p.Cout) continue;
        float v0 = acc[f][j][2 * h], v1 = acc[f][j][2 * h + 1];
        if (!p.ws) {
          v0 += p.bias[n];
          v0 = fmaxf(ALPHA * v0, v0);
          if (n + 1 < p.Cout) {
            v1 += p.bias[n + 1];
            v1 = fmaxf(ALPHA * v1, v1);
          }
        }
        if (pair && n + 1 < p.Cout) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          row[n] = v0;
          if (n + 1 < p.Cout) row[n + 1] = v1;
        }
      }
    }
}

// y = lrelu(sum of the split partials in split order + bias).
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws,
                     const float* __restrict__ bias, float* __restrict__ y,
                     long long mn, int Cout, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s += ws[k * mn + i];
    const float v = s + bias[i % Cout];
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
    e = cudaFuncSetAttribute(conv1d_lrelu_tc_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set[dev] = smem;
  }
  const dim3 grid((unsigned)((long long)((p.M + p.tile_m - 1) / p.tile_m) *
                             p.n_tiles),
                  splits);
  conv1d_lrelu_tc_kernel<BN><<<grid, 64 * (BN / WARP_N), smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// The text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// Launcher with a plain C interface (bound with ctypes). Pointers are device
// pointers; strides are in elements; the launch goes on `stream` and does not
// synchronise. The tiles, split and shared memory come from the wrapper's
// plan_launch (ops/kernels/conv1d_fused.py); ws holds splits * B * L_out *
// Cout floats when splits > 1 and may be null otherwise. Returns
// cudaGetLastError() of the last launch (0 when accepted), or
// cudaErrorInvalidValue for a plan or shape outside the kernel's limits: K <=
// 16, tile_n 24 or 48, tile_m <= 128, a slab that holds the tile's
// rows and halo, shared memory within the block's limit, the grid's extents.
extern "C" int conv1d_lrelu_f32(const float* x, const float* w,
                                const float* bias, float* y, float* ws, int B,
                                int L_out, int Cin, int Cout, int K,
                                long long x_sb, long long x_st, int tile_m,
                                int tile_n, int flat, int splits,
                                int per_split, int slab_rows, int smem,
                                cudaStream_t stream) {
  const long long M = (long long)B * L_out;
  if (K < 1 || K > K_MAX || B < 1 || L_out < 1 || Cin < 1 || Cout < 1 ||
      M >= (1LL << 31) || tile_m < 1 || tile_m > TILE_M ||
      (tile_n != WARP_N && tile_n != 2 * WARP_N) ||
      splits < 1 || splits > 65535 || per_split < 1 ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.y = y;
  p.ws = splits > 1 ? ws : nullptr;
  p.x_sb = x_sb;
  p.x_st = x_st;
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
    if (!(Cin == 2 || Cin == 4 || Cin == 6) || x_st != Cin)
      return (int)cudaErrorInvalidValue;
    p.lda = Cin;
    p.chunk_r = (K * Cin + 7) / 8 * 8;
    p.chunks = 1;
  } else {
    p.lda = CHUNK;
    p.chunk_r = CHUNK * K;
    p.chunks = (Cin + CHUNK - 1) / CHUNK;
  }
  p.per_split = per_split;
  if ((long long)splits * per_split < p.chunks ||
      (long long)(splits - 1) * per_split >= p.chunks)
    return (int)cudaErrorInvalidValue;
  // The slab must hold the tile's rows, K - 1 halo rows for each batch row
  // they touch, and 4 tail rows for the flat chunk's padded reads.
  const long long nb =
      tile_m < 2 ? 1 : std::min<long long>(B, (tile_m - 2) / L_out + 2);
  if (slab_rows < tile_m + (K - 1) * nb + 4) return (int)cudaErrorInvalidValue;
  p.slab_rows = slab_rows;
  p.slab_floats = (slab_rows * p.lda + 3) / 4 * 4;
  p.table_bytes = (slab_rows * 8 + 15) / 16 * 16;
  const long long need =
      p.table_bytes +
      (long long)STAGES * 4 * (p.slab_floats + p.chunk_r * (tile_n + 4));
  if (smem < need || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long grid_x =
      (M + tile_m - 1) / tile_m * (long long)p.n_tiles;
  if (grid_x >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // Copy widths: the largest of 4, 2, 1 floats that every row start allows.
  p.x_vec = 1;
  for (int v = 4; v > 1; v /= 2)
    if (p.lda % v == 0 && Cin % v == 0 && x_sb % v == 0 && x_st % v == 0 &&
        aligned(x, 4 * v)) {
      p.x_vec = v;
      break;
    }
  p.w_vec = (Cout % 4 == 0 && aligned(w, 16)) ? 4 : 1;

  cudaError_t e;
  if (tile_n == WARP_N)
    e = launch<WARP_N>(p, splits, smem, stream);
  else
    e = launch<2 * WARP_N>(p, splits, smem, stream);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = M * Cout;
  const int blocks = (int)std::min<long long>((mn + 255) / 256, 132 * 16);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, bias, y, mn, Cout,
                                                   splits);
  return (int)cudaGetLastError();
}
