// The statistics of an adaptive round on Hopper (sm_90a).
//
// Two kernels take the place of render/adaptive.py's eager statistics on the
// card; they replace no Pallas kernel. The JAX package's statistics
// (myraytracer_tpu/render/adaptive.py: _update_stats, _block_scores and
// lax.top_k) are jnp under jit, which XLA fuses. They were added because the
// port's plain versions of that arithmetic run as ~2,100 eager launches a
// round: _block_mean's 1,023 serial adds (XLA's CPU reduction order), the
// sort, and ~70 float64 ops a window in _update_stats' fma_f32 chains over
// the whole state.
//
// adaptive_select_kernel (one launch an auto round) computes _block_scores
// and select_blocks' top n_sel. One block a candidate row:
//
//   var_m = max((s2 - s1*s1 / max(r, 1)) / max(r - 1, 1), 0)   per pixel
//   score = block_mean(var_m) / (max(r, 1) * (r + 1)),  +inf where r < 2
//
// every product, quotient and difference rounded on its own (the build's
// -fmad=false and no fast math; the intrinsics say so again), the clamp
// keeping a NaN as torch.clamp does. block_mean sums each 32x32 window of
// the 32x64 block serially in row-major order, adds the two windows and
// multiplies by 1/2048: _block_mean's order, so the score is bitwise the
// plain one. Ids at or past n_live (the dead ids of the last stripe) score
// -inf. The last block to finish (a counter, the scores written through L2)
// ranks every candidate: its rank is the number of keys above its own, the
// key the score's order (NaN highest, -0 as +0) then the lower id, which is
// torch.sort(descending, stable)'s order. The candidates ranked below n_sel
// write the round's rows (the spare row for a dead id) and render ids (the
// sentinel for a dead id). What bounds it on an H100: the serial
// window sums (2 x 1,023 dependent adds a block, ~2 us) and the last block's
// n_cand^2 key comparisons (~5 us at 475 candidates), not bytes (s1 and s2
// of every candidate, 7.8 MB at 475, 2.3 us at 3.35 TB/s).
//
// adaptive_fold_kernel (one launch a _fold call) folds a call's F windows of
// block sums into fresh state tensors, as F calls of _update_stats do. For
// each pixel of a row named in idx, window by window, with n the row's
// sample count before the window:
//
//   sum = 0 + sums[w, j0] + sums[w, j1] + ...    (every j with idx[j] == row,
//                                                 in order: index_add_)
//   fb  = fma(fb, n, sum) / (n + k)
//   lum = ((sum0 + sum1 + sum2) * f32(1/3)) / k
//   s1 += lum;  s2 = fma(lum, lum, s2)
//
// the fused multiply-adds rounded once (fma_f32's result), the quotients
// true divisions, and the row's counters advance by F windows once however
// often its id repeats. A row that idx does not name is copied, s1 and s2
// as x + 0 (a -0 becomes +0), which is what the plain version adds. What
// bounds it: bytes, the F x n_sel x 2,048 x 12 B of window sums read once
// and the state read and written once (82.5 MB at the benchmark's shape,
// 25 us at 3.35 TB/s). One block a row and 256 pixels; its first warp finds
// the positions of idx that name the row, in order, with ballots.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBH = 32, kBW = 64, kPix = kBH * kBW;  // a block's pixels
constexpr int kWin = 32;                             // XLA's 32x32 reduce window
constexpr int kSelThreads = 512;
constexpr int kKeyTile = 2048;  // keys a rank pass holds in shared memory
constexpr int kFoldThreads = 256;
constexpr float kThird = 1.0f / 3.0f;  // the f32 1/3 of the channel mean

// A candidate's place in select_blocks' order: larger keys come first.
__device__ __forceinline__ unsigned long long order_key(float s, int id) {
  unsigned u;
  if (isnan(s)) {
    u = 0xffffffffu;  // torch.sort puts NaN above +inf
  } else {
    const unsigned b = __float_as_uint(s == 0.0f ? 0.0f : s);  // -0 ties +0
    u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)id);  // lower id first
}

__global__ void __launch_bounds__(kSelThreads)
    adaptive_select_kernel(const float* __restrict__ s1, const float* __restrict__ s2,
                           const int* __restrict__ r_b, int n_live, int n_sel, long long base,
                           long long sentinel, float* scores, unsigned* done,
                           long long* __restrict__ lidx, long long* __restrict__ rid) {
  __shared__ float var[kPix];
  __shared__ unsigned long long keys[kKeyTile];
  __shared__ float win[2];
  __shared__ bool last;
  const int n_cand = gridDim.x, row = blockIdx.x, t = threadIdx.x;
  const int r = r_b[row];
  float score = row >= n_live ? -INFINITY : INFINITY;
  if (row < n_live && r >= 2) {  // uniform over the block
    const float rf = __int2float_rn(r);
    const float rc = rf < 1.0f ? 1.0f : rf;
    float rm = __fsub_rn(rf, 1.0f);
    rm = rm < 1.0f ? 1.0f : rm;
    const float* a = s1 + (long long)row * kPix;
    const float* b = s2 + (long long)row * kPix;
    for (int p = t; p < kPix; p += kSelThreads) {
      const float x = a[p];
      const float v = __fdiv_rn(__fsub_rn(b[p], __fdiv_rn(__fmul_rn(x, x), rc)), rm);
      var[p] = v < 0.0f ? 0.0f : v;  // torch.clamp(min=0): NaN and -0 stay
    }
    __syncthreads();
    if (t < 2) {  // window t: columns [32t, 32t + 32), row-major, serially
      const float* w = var + t * kWin;
      float acc = w[0];
      for (int x = 1; x < kWin; ++x) acc = __fadd_rn(acc, w[x]);
      for (int y = 1; y < kBH; ++y)
        for (int x = 0; x < kWin; ++x) acc = __fadd_rn(acc, w[y * kBW + x]);
      win[t] = acc;
    }
    __syncthreads();
    const float mean = __fmul_rn(__fadd_rn(win[0], win[1]), 1.0f / kPix);
    score = __fdiv_rn(mean, __fmul_rn(rc, __fadd_rn(rf, 1.0f)));
  }
  if (t == 0) {
    scores[row] = score;
    __threadfence();
    last = atomicAdd(done, 1u) == (unsigned)n_cand - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i0 = 0; i0 < n_cand; i0 += kSelThreads) {
    const int i = i0 + t;
    const unsigned long long ki = i < n_cand ? order_key(__ldcg(scores + i), i) : 0ull;
    int rank = 0;
    for (int j0 = 0; j0 < n_cand; j0 += kKeyTile) {
      const int nj = min(kKeyTile, n_cand - j0);
      __syncthreads();
      for (int j = t; j < nj; j += kSelThreads) keys[j] = order_key(__ldcg(scores + j0 + j), j0 + j);
      __syncthreads();
      for (int j = 0; j < nj; ++j) rank += keys[j] > ki;
    }
    if (i < n_cand && rank < n_sel) {
      const bool alive = i < n_live;
      lidx[rank] = alive ? i : n_cand;  // the spare row
      rid[rank] = alive ? base + i : sentinel;
    }
  }
}

__global__ void __launch_bounds__(kFoldThreads)
    adaptive_fold_kernel(const float* __restrict__ fb, const float* __restrict__ s1,
                         const float* __restrict__ s2, const int* __restrict__ n_b,
                         const int* __restrict__ r_b, const long long* __restrict__ cursor,
                         const long long* __restrict__ idx, int n_sel,
                         const float* __restrict__ sums, int F, int k, float* __restrict__ fb_o,
                         float* __restrict__ s1_o, float* __restrict__ s2_o, int* __restrict__ n_o,
                         int* __restrict__ r_o, long long* __restrict__ cur_o) {
  extern __shared__ int occ[];  // the positions j with idx[j] == row, in order
  __shared__ int n_occ;
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 32) {
    int count = 0;
    for (int j0 = 0; j0 < n_sel; j0 += 32) {
      const int j = j0 + t;
      const bool hit = j < n_sel && idx[j] == row;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) occ[count + __popc(m & ((1u << t) - 1u))] = j;
      count += __popc(m);
    }
    if (t == 0) n_occ = count;
  }
  __syncthreads();
  const int nocc = n_occ;
  if (blockIdx.y == 0 && t == 0) {
    const unsigned w = nocc ? (unsigned)F : 0u;
    n_o[row] = (int)((unsigned)n_b[row] + w * (unsigned)k);  // int32 wraps as torch's
    r_o[row] = (int)((unsigned)r_b[row] + w);
    cur_o[row] = cursor[row] + (long long)w * k;
  }
  const int p = blockIdx.y * kFoldThreads + t;
  const long long px = row * kPix + p;
  float c[3] = {fb[3 * px], fb[3 * px + 1], fb[3 * px + 2]};
  float a = s1[px], b = s2[px];
  if (nocc == 0) {  // x + 0, as the plain version adds a zero lum: -0 becomes +0
    a = a == 0.0f ? 0.0f : a;
    b = b == 0.0f ? 0.0f : b;
  } else {
    const float kf = (float)k;
    unsigned n = (unsigned)n_b[row];
    for (int f = 0; f < F; ++f, n += (unsigned)k) {
      float sc[3] = {0.0f, 0.0f, 0.0f};
      for (int o = 0; o < nocc; ++o) {
        const float* s = sums + (((long long)f * n_sel + occ[o]) * kPix + p) * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) sc[ch] = __fadd_rn(sc[ch], __ldg(s + ch));
      }
      const float nf = __int2float_rn((int)n);
      const float den = __fadd_rn(nf, kf);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[ch] = __fdiv_rn(__fmaf_rn(c[ch], nf, sc[ch]), den);
      const float lum =
          __fdiv_rn(__fmul_rn(__fadd_rn(__fadd_rn(sc[0], sc[1]), sc[2]), kThird), kf);
      a = __fadd_rn(a, lum);
      b = __fmaf_rn(lum, lum, b);
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) fb_o[3 * px + ch] = c[ch];
  s1_o[px] = a;
  s2_o[px] = b;
}

}  // namespace

// s1, s2 [nb1, 32, 64], r_b [nb1] i32; the candidates are rows 0 .. nb1 - 2
// (block ids base ..), row nb1 - 1 the spare; ``work`` [nb1] f32 scratch
// (the scores and the finish counter); the outputs [n_sel] i64. Returns the
// launch's cudaError_t.
extern "C" int mrt_adaptive_select(const float* s1, const float* s2, const int* r_b, int nb1,
                                   int n_live, int n_sel, long long base, long long sentinel,
                                   float* work, long long* lidx, long long* rid, void* stream) {
  const int n_cand = nb1 - 1;
  if (n_cand < 1 || n_sel < 1 || n_sel > n_cand || n_live < 0 || n_live > n_cand)
    return (int)cudaErrorInvalidValue;
  unsigned* done = reinterpret_cast<unsigned*>(work + n_cand);
  const cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  adaptive_select_kernel<<<n_cand, kSelThreads, 0, (cudaStream_t)stream>>>(
      s1, s2, r_b, n_live, n_sel, base, sentinel, work, done, lidx, rid);
  return (int)cudaGetLastError();
}

// The state (fb [nb1, 32, 64, 3], s1 and s2 [nb1, 32, 64] f32, n_b and r_b
// [nb1] i32, cursor [nb1] i64) and its fresh copy ``*_o``, none aliasing
// another; idx [n_sel] i64 rows; sums [F, n_sel, 32, 64, 3] f32. Returns the
// launch's cudaError_t.
extern "C" int mrt_adaptive_fold(const float* fb, const float* s1, const float* s2,
                                 const int* n_b, const int* r_b, const long long* cursor,
                                 int nb1, const long long* idx, int n_sel, const float* sums,
                                 int F, int k, float* fb_o, float* s1_o, float* s2_o, int* n_o,
                                 int* r_o, long long* cur_o, void* stream) {
  if (nb1 < 1 || n_sel < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_sel * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        adaptive_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(nb1, kPix / kFoldThreads);
  adaptive_fold_kernel<<<grid, kFoldThreads, smem, (cudaStream_t)stream>>>(
      fb, s1, s2, n_b, r_b, cursor, idx, n_sel, sums, F, k, fb_o, s1_o, s2_o, n_o, r_o, cur_o);
  return (int)cudaGetLastError();
}
