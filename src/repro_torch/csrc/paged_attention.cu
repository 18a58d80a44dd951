// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over the sequence's page table -- the paper's striped page READ fused with
// attention.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_pallas
// (its _kernel). Same contract: grid (B, K) = (sequence, kv-head); each
// program walks its table in order, keeps an f32 online softmax for the
// G = H/K query heads of its kv-head, and emits the UNNORMALISED
// o (B,H,D), m (B,H), l (B,H) in f32, so a split-K combine stays possible.
// A cached token (r, t) has position page_pos[b,r] + t and is valid iff
// lo <= pos < length with lo = max(0, length - window), and its page id
// (minus page_offset) lies in [0, P).
//
// What bounds it on this card: device-memory bytes. Each (sequence,
// kv-head) reads every valid K and V page once (T*D elements each) and does
// 4*G*T*D flops per page -- about 2 flops per byte in bf16, far below the
// ~295 flops/byte where the tensor cores would become the limit. So the
// design spends nothing on tensor cores and everything on reading each
// needed byte once:
//   * pages whose id is out of range are SKIPPED, never read (the TPU
//     kernel clamps the id and reads a page it then masks), and so are pages
//     with no token in [lo, length) -- the engine's inactive rows (every id
//     the sentinel n_pool_pages, length 0) read nothing at all;
//   * one (T, D) K page and V page at a time are staged in shared memory as
//     f32 (the K rows padded to D+1 floats so that the score loop, where
//     neighbouring threads take neighbouring tokens, hits distinct banks);
//   * scores, the per-head softmax statistics (one warp per head, shuffles)
//     and the P.V update each take one pass over the staged page; the f32
//     accumulator lives in shared memory, one owner thread per element.
// Masked scores use the finite sentinel -1e30, never -inf, and p is forced
// to 0 outside the mask, so an all-masked row returns o=0, l=0, m=-1e30.
// Known limit, left for a later change: B*K CTAs (64 at 8 slots of
// llama3.2-1b) leave about half of the 132 SMs idle; splitting a sequence's
// pages over CTAs with a combine pass (flash-decoding) would fill them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q,           // (B, H, D)
    const KVT* __restrict__ pool_k,     // (P, T, K, D)
    const KVT* __restrict__ pool_v,     // (P, T, K, D)
    const int* __restrict__ tables,     // (B, R)
    const int* __restrict__ page_pos,   // (B, R)
    const int* __restrict__ lengths,    // (B,)
    float* __restrict__ o_out,          // (B, H, D)
    float* __restrict__ m_out,          // (B, H)
    float* __restrict__ l_out,          // (B, H)
    int H, int K, int D, int T, int R, int P, int window, int page_offset,
    float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                  // G*D
  float* k_s = q_s + G * D;           // T*(D+1), rows padded
  float* v_s = k_s + T * (D + 1);     // T*D
  float* p_s = v_s + T * D;           // G*T scores, then probabilities
  float* acc_s = p_s + G * T;         // G*D
  float* m_s = acc_s + G * D;         // G
  float* l_s = m_s + G;               // G
  float* alpha_s = l_s + G;           // G

  // the G query heads of this kv-head are contiguous: q[b, kvh*G + g, d]
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  for (int i = tid; i < G * D; i += blockDim.x) {
    q_s[i] = to_f32(q[head0 * D + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int length = lengths[b];
  const int lo = window > 0 ? max(0, length - window) : 0;
  __syncthreads();

  for (int r = 0; r < R; ++r) {
    // uniform over the block: every thread takes the same branch
    const int pid = tables[b * R + r] - page_offset;
    const int base = page_pos[b * R + r];
    if (pid < 0 || pid >= P) continue;
    if (base + T <= lo || base >= length) continue;

    for (int i = tid; i < T * D; i += blockDim.x) {
      const int t = i / D;
      const int d = i - t * D;
      const size_t off = (((size_t)pid * T + t) * K + kvh) * D + d;
      k_s[t * (D + 1) + d] = to_f32(pool_k[off]);
      v_s[i] = to_f32(pool_v[off]);
    }
    __syncthreads();

    for (int i = tid; i < G * T; i += blockDim.x) {
      const int g = i / T;
      const int t = i - g * T;
      const float* qg = q_s + g * D;
      const float* kt = k_s + t * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kt[d], dot);
      const int pos = base + t;
      p_s[i] = (pos >= lo && pos < length) ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += n_warps) {
      float mx = kNegInf;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, p_s[g * T + t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < T; t += 32) {
        const int pos = base + t;
        const float p = (pos >= lo && pos < length) ? expf(p_s[g * T + t] - m_new) : 0.f;
        p_s[g * T + t] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {  // every lane read m_prev before the shuffles above
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = p_s + g * T;
      float pv = 0.f;
      for (int t = 0; t < T; ++t) pv = fmaf(pg[t], v_s[t * D + d], pv);
      acc_s[i] = acc_s[i] * alpha_s[g] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += blockDim.x) o_out[head0 * D + i] = acc_s[i];
  for (int g = tid; g < G; g += blockDim.x) {
    m_out[head0 + g] = m_s[g];
    l_out[head0 + g] = l_s[g];
  }
}

template <typename QT, typename KVT>
int launch(const void* q, const void* pool_k, const void* pool_v, const int* tables,
           const int* page_pos, const int* lengths, float* o, float* m, float* l,
           int B, int H, int K, int D, int T, int R, int P, int window,
           int page_offset, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + (size_t)T * (D + 1) + (size_t)T * D + (size_t)G * T + 3 * G);
  auto kernel = paged_decode_kernel<QT, KVT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, K), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(pool_k),
      static_cast<const KVT*>(pool_v), tables, page_pos, lengths, o, m, l,
      H, K, D, T, R, P, window, page_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// dtype pair this file does not instantiate.
int paged_attention_fwd(const void* q, const void* pool_k, const void* pool_v,
                        const void* tables, const void* page_pos, const void* lengths,
                        void* o, void* m, void* l, int B, int H, int K, int D,
                        int T, int R, int P, int window, int page_offset,
                        float scale, int q_dtype, int kv_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const int*>(tables);
  auto pp = static_cast<const int*>(page_pos);
  auto ln = static_cast<const int*>(lengths);
  auto of = static_cast<float*>(o);
  auto mf = static_cast<float*>(m);
  auto lf = static_cast<float*>(l);
#define REPRO_LAUNCH(QT, KVT)                                                     \
  return launch<QT, KVT>(q, pool_k, pool_v, tb, pp, ln, of, mf, lf, B, H, K, D, T, \
                         R, P, window, page_offset, scale, s)
  if (q_dtype == 0 && kv_dtype == 0) REPRO_LAUNCH(float, float);
  if (q_dtype == 0 && kv_dtype == 1) REPRO_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) REPRO_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
  return -1;
}

}  // extern "C"
