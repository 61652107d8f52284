// Valid conv1d + bias + LeakyReLU in fp32 for Hopper (sm_90a), channel-major,
// as one GEMM over the K*Cin contraction per output tile.
//
// Replaces the TPU kernel waveunet_tpu/ops/pallas/conv1d_im2col.py::
// conv1d_lrelu_im2col:
//
//     y[b, o, t] = lrelu( sum_{k,c} W2[o, k*Cin + c] * x[b, c, t + k]
//                         + bias[o] )
//
// with x [B, Cin, L] (any batch, channel and time stride, so a decimated
// view x[:, :, ::2] needs no copy), W2[o, k*Cin + c] = w[k, c, o], bias
// [Cout], y [B, Cout, L - K + 1] contiguous. The kernel reads W2 transposed,
// W2t [K*Cin, Cout] contiguous, which is the TF-layout w [K, Cin, Cout] as it
// is: a block then stages 64 adjacent output channels of one contraction
// index in one coalesced read. (Read as W2 [Cout, K*Cin], the TPU kernel's
// layout for its matrix unit, every staged value was a 32-byte sector of its
// own, and the kernel was markedly slower on the H100.) The patch
// matrix P[k*Cin + c, t] = x[b, c, t + k] of the im2col form is never
// written anywhere: it exists only as shifted reads of a staged input slab,
// as the TPU kernel kept it in VMEM.
//
// What bounds it on this card: operations, on every layer but the first. A
// Wave-U-Net layer does 2*K*Cin FLOP per output value (K*Cin = 30 at the
// first layer, up to 4,320 at the bottleneck), far above the H100's fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte). Parity with the JAX
// package needs real fp32, so the tensor cores (TF32 keeps 10 mantissa bits)
// are out and the limit is the CUDA cores' fp32 FMA rate. The first layer
// (Cin = 2) is bound by the bytes of its 24-channel output instead.
//
// Design: one block computes a [TILE_CO x TILE_L] output tile of one batch
// row; the contraction is the loop inside the block. For each chunk of CI
// input channels it stages in shared memory the haloed slab
// x[b, c-chunk, t0 : t0 + TILE_L + K - 1] (time contiguous, so the loads
// coalesce for a contiguous x) and the matching W2 columns as [c][k][o].
// Every thread owns 4 adjacent output channels x 8 adjacent time steps. Per
// input channel it reads its 8 + K - 1 slab values into registers once, and
// the K taps are shifts of that register window: P's K rows for the channel
// cost one slab read, and each tap costs one 16-byte weight read for 32 FMA.
// K is a template argument, so the window's indices are constants and the
// tap loop has no run-time bound: the model's K = 15 and K = 5 have kernels
// of their own, any other K <= 16 goes to one that masks the taps past K.
// The launch bound caps a thread at 64 registers, so four blocks (32 warps)
// share an SM and hide each other's shared-memory and staging latency; on
// the H100 both choices were faster at the forward's shapes than a run-time
// tap bound at three blocks an SM. Channels past Cin and
// output channels past Cout are skipped, not computed as zeros (Cin = 2 and
// Cout = 24 at the first layer). Bias and LeakyReLU are applied in the
// epilogue. Every ragged edge is masked: L_out is no multiple of TILE_L,
// Cout runs from 24 to 312. wgmma, TMA, TF32 and multi-stage pipelining are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_L = 128;            // output time steps per block
constexpr int TILE_CO = 64;            // output channels per block
constexpr int CI = 8;                  // input channels per shared-memory stage
constexpr int K_MAX = 16;              // widest filter the block stages
constexpr int THREADS = 256;           // 16 channel groups x 16 time groups
constexpr int T_PER = TILE_L / 16;     // adjacent time steps per thread
constexpr int O_PER = TILE_CO / 16;    // adjacent output channels per thread
constexpr float ALPHA = 0.2f;          // LeakyReLU slope of every Wave-U-Net

static_assert(O_PER == 4, "a thread reads its weights as one float4");
static_assert(T_PER % 4 == 0, "a thread reads its slab window as float4s");

template <int KT>
struct Slab {
  // float4s of one channel's slab window per thread: T_PER + KT - 1 values
  static constexpr int NV = (T_PER + KT - 1 + 3) / 4;
  // staged slab row: the last thread's window end, a multiple of 4, and at
  // least the TILE_L + KT - 1 values the tile needs
  static constexpr int ROW = 15 * T_PER + 4 * NV;
  static_assert(ROW >= TILE_L + KT - 1, "slab row shorter than the halo");
};

// KT is the filter width: K == KT, except for KT == K_MAX, which serves any
// K <= K_MAX and masks the taps k >= K.
template <int KT>
__global__ void __launch_bounds__(THREADS, 4)
conv1d_lrelu_im2col_kernel(const float* __restrict__ x,
                           const float* __restrict__ w2t,
                           const float* __restrict__ bias,
                           float* __restrict__ y, int L_out, int Cin,
                           int Cout, int K, long long x_sb, long long x_sc,
                           long long x_st) {
  constexpr int NV = Slab<KT>::NV;
  constexpr int ROW = Slab<KT>::ROW;
  __shared__ __align__(16) float xs[CI * ROW];             // [c][t]
  __shared__ __align__(16) float ws[CI * KT * TILE_CO];    // [c][k][o]

  const int tt = threadIdx.x % 16;   // time steps t0 + tt*T_PER + (0..7)
  const int tc = threadIdx.x / 16;   // output channels o0 + tc*4 + (0..3)
  const int t0 = blockIdx.x * TILE_L;
  const int o0 = blockIdx.y * TILE_CO;
  const int b = blockIdx.z;
  const float* xb = x + (long long)b * x_sb;
  const int L_in = L_out + K - 1;
  const int so = threadIdx.x % TILE_CO;  // the output channel it stages
  // warps whose output channels all lie past Cout only help to stage
  const bool active = o0 + tc * O_PER < Cout;

  float acc[O_PER][T_PER];
#pragma unroll
  for (int j = 0; j < O_PER; ++j)
#pragma unroll
    for (int r = 0; r < T_PER; ++r) acc[j][r] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CI) {
    const int nc = min(CI, Cin - c0);
    for (int i = threadIdx.x; i < nc * ROW; i += THREADS) {
      const int c = i / ROW, t = t0 + i % ROW;
      xs[i] = t < L_in ? xb[(c0 + c) * x_sc + t * x_st] : 0.f;
    }
    for (int k = 0; k < K; ++k)
      for (int c = threadIdx.x / TILE_CO; c < nc; c += THREADS / TILE_CO) {
        const long long row = (long long)k * Cin + c0 + c;  // of W2t
        ws[(c * KT + k) * TILE_CO + so] =
            o0 + so < Cout ? w2t[row * Cout + o0 + so] : 0.f;
      }
    __syncthreads();

    if (active) {
      for (int c = 0; c < nc; ++c) {
        float xv[4 * NV];
        const float4* xr =
            reinterpret_cast<const float4*>(&xs[c * ROW + tt * T_PER]);
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const float4 v = xr[q];
          xv[4 * q] = v.x;
          xv[4 * q + 1] = v.y;
          xv[4 * q + 2] = v.z;
          xv[4 * q + 3] = v.w;
        }
        const float* wc = &ws[c * KT * TILE_CO + tc * O_PER];
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          if (KT < K_MAX || k < K) {
            const float4 wv =
                *reinterpret_cast<const float4*>(&wc[k * TILE_CO]);
#pragma unroll
            for (int r = 0; r < T_PER; ++r) {
              const float a = xv[r + k];
              acc[0][r] = fmaf(wv.x, a, acc[0][r]);
              acc[1][r] = fmaf(wv.y, a, acc[1][r]);
              acc[2][r] = fmaf(wv.z, a, acc[2][r]);
              acc[3][r] = fmaf(wv.w, a, acc[3][r]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < O_PER; ++j) {
    const int o = o0 + tc * O_PER + j;
    if (o >= Cout) continue;
    const float bo = bias[o];
    float* yr = y + ((long long)b * Cout + o) * L_out;
#pragma unroll
    for (int r = 0; r < T_PER; ++r) {
      const int t = t0 + tt * T_PER + r;
      if (t < L_out) {
        const float v = acc[j][r] + bo;
        yr[t] = fmaxf(ALPHA * v, v);
      }
    }
  }
}

}  // namespace

// Launcher with a plain C interface (bound with ctypes). Pointers are device
// pointers; strides are in elements; the launch goes on `stream` and does not
// synchronise. Returns cudaGetLastError() (0 when the launch was accepted),
// or cudaErrorInvalidValue for shapes outside the kernel's limits: K <= K_MAX,
// B <= 65535 (the grid's z extent), and L_out small enough that the tile's
// slab index t0 + ROW stays an int.
extern "C" int conv1d_lrelu_im2col_f32(const float* x, const float* w2t,
                                       const float* bias, float* y, int B,
                                       int L_out, int Cin, int Cout, int K,
                                       long long x_sb, long long x_sc,
                                       long long x_st, cudaStream_t stream) {
  if (K < 1 || K > K_MAX || B < 1 || B > 65535 || L_out < 1 ||
      L_out > (1 << 30) || Cin < 1 || Cout < 1 ||
      (Cout + TILE_CO - 1) / TILE_CO > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((L_out + TILE_L - 1) / TILE_L, (Cout + TILE_CO - 1) / TILE_CO,
                  B);
  if (K == 15)
    conv1d_lrelu_im2col_kernel<15><<<grid, THREADS, 0, stream>>>(
        x, w2t, bias, y, L_out, Cin, Cout, K, x_sb, x_sc, x_st);
  else if (K == 5)
    conv1d_lrelu_im2col_kernel<5><<<grid, THREADS, 0, stream>>>(
        x, w2t, bias, y, L_out, Cin, Cout, K, x_sb, x_sc, x_st);
  else
    conv1d_lrelu_im2col_kernel<K_MAX><<<grid, THREADS, 0, stream>>>(
        x, w2t, bias, y, L_out, Cin, Cout, K, x_sb, x_sc, x_st);
  return (int)cudaGetLastError();
}
