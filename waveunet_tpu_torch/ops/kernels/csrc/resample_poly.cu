// Polyphase sample-rate conversion for Hopper (sm_90a): fp32 or float64
// audio in, fp32 out, float64 taps, products and sums.
//
// Replaces no TPU kernel: the JAX package resamples with scipy's upfirdn on
// the host (waveunet_tpu/ops/resample.py::resample) or with XLA
// convolutions (resample_jnp). The port resamples songs that arrive at
// another rate than the model's on the card, in the host path's precision,
// so the card need not wait for the host's upfirdn.
//
// With h the Kaiser low-pass of L = 2*half + 1 taps on the grid of p times
// the input rate (ops/resample.py::_kaiser_filter) and x' the input behind
// c zeros, output j of _resample_plan is
//
//     y[j] = sum_k h[phi + k*p] * x'[base - k],   (start + j)*q = base*p + phi,
//
// over the K_phi = (L - 1 - phi) / p + 1 taps of phase phi, a term left out
// where base - k falls outside x (the host's zero padding, here by index
// bounds). The bank holds each phase's sub-filter reversed,
// bank[phi][i] = h[phi + (K_phi - 1 - i)*p], in rows of kmax, so output j
// reads x from lo = base - (K_phi - 1) - c upwards: y[j] = sum_i
// bank[phi][i] * x[lo + i].
//
// What bounds it on this card: at 44,100 -> 22,050 (p = 1, q = 2, 273 taps)
// 273 float64 multiply-adds an output and channel against 12 bytes moved,
// so the fp64 rate (the card's peak is 67 TFLOP/s on the tensor cores;
// this kernel's fma run on the CUDA cores, 34 TFLOP/s) and the L1 traffic
// of the overlapping input windows, not device memory.
//
// Design: outputs j = r + p*t share phase phi_r for every t, and their input
// windows step by q, so thread idx takes r = idx / T, t = idx % T (T outputs
// a phase): a warp holds consecutive t of one phase, reads the same taps
// (one broadcast load) and neighbouring input windows (cached in L1). Every
// channel of an output is summed by one thread, in the order of i, with
// fma: the result does not depend on the launch, so every rank of a mesh
// gets the same bits. Each sum is rounded to fp32 once, at the end, as the
// host's upfirdn rounds its float64 sums, whether the audio came as fp32 or
// float64 (then read as it is, so the host's terms exactly). Indices
// on the up-by-p grid are 64-bit: (start + j)*q passes 2^31 at 8,192 ->
// 44,100 (p = 11,025).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Two channels of one frame, read in one load: float2 or double2.
template <typename In> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// In the input's type; CC channels known at compile time (1, or 2 read as
// one Pair), or 0: ``C`` channels, one after the other.
template <typename In, int CC>
__global__ void __launch_bounds__(THREADS)
resample_poly_kernel(const In* __restrict__ x,
                     const double* __restrict__ bank, float* __restrict__ y,
                     long long n, int C, long long n_out, long long p,
                     long long q, long long L, int kmax, long long c,
                     long long start, long long T, long long total) {
  for (long long idx = blockIdx.x * (long long)THREADS + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * THREADS) {
    const long long r = idx / T;
    const long long t = idx - r * T;
    const long long j = r + p * t;
    if (j >= n_out) continue;
    const long long u = (start + r) * q;
    const long long phi = u % p;
    const long long base = u / p + q * t;
    const long long K = (L - 1 - phi) / p + 1;
    const long long lo = base - (K - 1) - c;
    const long long i0 = lo < 0 ? (-lo < K ? -lo : K) : 0;
    const long long i1 = n - lo < K ? (n - lo > i0 ? n - lo : i0) : K;
    const double* g = bank + phi * kmax;
    if (CC == 2) {
      using P = typename Pair<In>::type;
      const P* x2 = reinterpret_cast<const P*>(x);
      double a0 = 0.0, a1 = 0.0;
      for (long long i = i0; i < i1; ++i) {
        const double w = g[i];
        const P v = x2[lo + i];
        a0 = fma(w, (double)v.x, a0);
        a1 = fma(w, (double)v.y, a1);
      }
      reinterpret_cast<float2*>(y)[j] = make_float2((float)a0, (float)a1);
    } else if (CC == 1) {
      double a = 0.0;
      for (long long i = i0; i < i1; ++i) a = fma(g[i], (double)x[lo + i], a);
      y[j] = (float)a;
    } else {
      for (int ch = 0; ch < C; ++ch) {
        double a = 0.0;
        for (long long i = i0; i < i1; ++i)
          a = fma(g[i], (double)x[(lo + i) * C + ch], a);
        y[j * C + ch] = (float)a;
      }
    }
  }
}

template <typename In>
int launch(const In* x, const double* bank, float* y, long long n, int C,
           long long n_out, long long p, long long q, long long L, int kmax,
           long long c, long long start, cudaStream_t stream) {
  if (n < 1 || C < 1 || n_out < 1 || p < 1 || q < 1 || L < p || kmax < 1 ||
      (L - 1) / p + 1 > kmax || c < 0 || start < 0)
    return (int)cudaErrorInvalidValue;
  const long long phases = p < n_out ? p : n_out;
  const long long T = (n_out + p - 1) / p;
  const long long total = phases * T;
  const long long blocks = (total + THREADS - 1) / THREADS;
  const unsigned grid = blocks < 132ll * 16ll ? (unsigned)blocks : 132u * 16u;
  const bool aligned = ((uintptr_t)x % (2 * sizeof(In)) == 0) &&
                       ((uintptr_t)y % 8 == 0);
  if (C == 2 && aligned) {
    resample_poly_kernel<In, 2><<<grid, THREADS, 0, stream>>>(
        x, bank, y, n, C, n_out, p, q, L, kmax, c, start, T, total);
  } else if (C == 1) {
    resample_poly_kernel<In, 1><<<grid, THREADS, 0, stream>>>(
        x, bank, y, n, C, n_out, p, q, L, kmax, c, start, T, total);
  } else {
    resample_poly_kernel<In, 0><<<grid, THREADS, 0, stream>>>(
        x, bank, y, n, C, n_out, p, q, L, kmax, c, start, T, total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes), named by the
// input's type. x [n, C] (fp32 or float64) and y [n_out, C] (fp32) are
// contiguous device tensors, bank [p, kmax] a contiguous float64 one; L, c
// and start as ops/resample.py::_resample_plan gives them. The launch goes
// on `stream` and does not synchronise. Returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int resample_poly_f32(const float* x, const double* bank, float* y,
                                 long long n, int C, long long n_out,
                                 long long p, long long q, long long L,
                                 int kmax, long long c, long long start,
                                 cudaStream_t stream) {
  return launch(x, bank, y, n, C, n_out, p, q, L, kmax, c, start, stream);
}

extern "C" int resample_poly_f64(const double* x, const double* bank,
                                 float* y, long long n, int C,
                                 long long n_out, long long p, long long q,
                                 long long L, int kmax, long long c,
                                 long long start, cudaStream_t stream) {
  return launch(x, bank, y, n, C, n_out, p, q, L, kmax, c, start, stream);
}
