// The framebuffer blend of a progressive step on Hopper (sm_90a).
//
// blend_frames_kernel blends the K per-frame images of one step into the
// accumulation framebuffer in frame order, as render/session.py's
// _blend_chain does on the CPU. It replaces no Pallas kernel: the JAX
// package's blend (myraytracer_tpu/render/session.py:_blend_chain) is jnp
// under jit, a lax.scan that XLA compiles with the fb * w product fused into
// the add. It was added because the port's plain version of that fusion
// (fma_f32, an f32 fused multiply-add emulated in float64 with round-to-odd)
// costs about twenty elementwise launches a frame over float64 temporaries.
//
// For each pixel (y, x) and channel c, for k = 0 .. K-1:
//
//   t  = img[k, c, y, x] * (1 - w[k])      (two f32 roundings)
//   fb = fma(fb, w[k], t)                  (one rounding)
//
// from the input framebuffer, into a fresh one. __fmaf_rn is the correctly
// rounded fused multiply-add that fma_f32 emulates, and the build's
// -fmad=false and no fast math keep every other product and sum rounded on
// its own with denormals kept, so the result is bitwise the plain chain's.
//
// What bounds it on an H100: bytes. A step reads K images and the
// framebuffer and writes the framebuffer once, (K + 2) x H x W x 12 bytes
// (207 MB at 1200x800, K = 16: 62 us at 3.35 TB/s), against 6K FP32
// operations a pixel. The design spends nothing else:
//
// * one thread a pixel, a block 256 consecutive pixels of the [H, W, 3]
//   framebuffer, whose 3 KB the block reads and writes as one coalesced run
//   through shared memory (a thread's three channels sit 3 floats apart
//   there, an odd stride: no bank conflicts);
// * the running value stays in registers across all K frames, so the
//   framebuffer is read once and written once whatever K is;
// * a frame's three channels are read from its planes, neighbouring threads
//   on neighbouring addresses, four frames' loads issued together before
//   their dependent multiply-adds, to keep enough bytes in flight;
// * the image comes with its four strides, so the K = 1 step's channels-last
//   view of the trace kernel's [H, W, 3] image is read where it lies, with no
//   copy; the weights are read from the device array the session uploads.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // pixels (threads) of a block
constexpr int kUnroll = 4;   // frames whose loads are issued together

__device__ __forceinline__ void blend_one(float (&fb)[3], const float (&v)[3], float w) {
  const float keep = __fsub_rn(1.0f, w);
#pragma unroll
  for (int c = 0; c < 3; ++c) fb[c] = __fmaf_rn(fb[c], w, __fmul_rn(v[c], keep));
}

__global__ void __launch_bounds__(kBlock)
    blend_frames_kernel(const float* __restrict__ fb, const float* __restrict__ img, long long sk,
                        long long sc, long long sy, long long sx, const float* __restrict__ w,
                        int K, int W, long long n_pix, float* __restrict__ out) {
  __shared__ float tile[3 * kBlock];
  const long long p0 = (long long)blockIdx.x * kBlock;
  const int np = (int)min((long long)kBlock, n_pix - p0);  // pixels of this block
  const float* src = fb + 3 * p0;
  for (int i = threadIdx.x; i < 3 * np; i += kBlock) tile[i] = src[i];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < np) {
    const long long p = p0 + t;
    const long long y = p / W, x = p - y * W;
    const float* px = img + y * sy + x * sx;
    float acc[3] = {tile[3 * t], tile[3 * t + 1], tile[3 * t + 2]};
    int k = 0;
    for (; k + kUnroll <= K; k += kUnroll) {
      float v[kUnroll][3];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const float* f = px + (k + j) * sk;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[j][c] = __ldg(f + c * sc);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) blend_one(acc, v[j], __ldg(w + k + j));
    }
    for (; k < K; ++k) {
      const float* f = px + k * sk;
      const float v[3] = {__ldg(f), __ldg(f + sc), __ldg(f + 2 * sc)};
      blend_one(acc, v, __ldg(w + k));
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) tile[3 * t + c] = acc[c];
  }
  __syncthreads();
  float* dst = out + 3 * p0;
  for (int i = threadIdx.x; i < 3 * np; i += kBlock) dst[i] = tile[i];
}

}  // namespace

// ``fb`` and ``out`` [H, W, 3] contiguous, ``out`` not ``fb``; ``img``
// [K, 3, H, W] at element strides (sk, sc, sy, sx); ``w`` [K]. Returns the
// launch's cudaError_t.
extern "C" int mrt_blend_frames(const float* fb, const float* img, long long sk, long long sc,
                                long long sy, long long sx, const float* w, int K, int H, int W,
                                float* out, void* stream) {
  if (K < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)H * W;
  if (n_pix == 0) return (int)cudaSuccess;
  const long long blocks = (n_pix + kBlock - 1) / kBlock;
  blend_frames_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      fb, img, sk, sc, sy, sx, w, K, W, n_pix, out);
  return (int)cudaGetLastError();
}
