// Flash attention forward for NVIDIA Hopper (sm_90a): the prefill kernel.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_kernel /
// _flash_kernel (Pallas, TPU).  Same function: causal GQA attention with an
// optional sliding window, scale 1/sqrt(D), online softmax in f32 over KV
// blocks, masks k < Skv, k <= q and k > q - window, fully masked rows -> 0.
// Layouts are the model's own: q/o (B, Sq, Hq, D), k/v (B, Skv, Hkv, D),
// contiguous, bf16 or f32; D a multiple of 8 and at most 128.
//
// What bounds it on an H100: at the serving engine's largest prefill bucket
// (S = 1024, Hq = 16, D = 128, bf16) the causal work is 2*S^2*D*Hq ~ 4.3
// GFLOP, about 4.3 us at 989 TFLOP/s of bf16 tensor-core rate, while q, k,
// v and o move only ~12.6 MB (~3.8 us at 3.35 TB/s): compute-bound.
//
// What this design does about it: it is the simple, exact first version.
// One CTA of 256 threads per (batch * q-head, 64-row q block); the KV-block
// loop runs inside the CTA and its range is cut at the causal and window
// bounds, so fully masked blocks cost nothing.  Q, K and V tiles are staged
// in shared memory as f32, each thread owns a 4x4 block of the 64x64 score
// tile and a 4x8 block of the 64xD accumulator in registers (f32 SIMT FMAs,
// register-blocked like a classic SGEMM).  GQA: kv_head = q_head / G, so
// the G query heads of a group read the same K/V rows from L2.  It does not
// use the tensor cores (wgmma) or TMA yet, so it runs at the f32 SIMT rate
// (67 TFLOP/s peak), not the bf16 tensor-core rate: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // keys per KV block
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 score block each
constexpr int LD = BQ + 4;    // padded row of the transposed tiles (floats)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory: Qt [D][LD] + KPt [max(D, BK)][LD] + Vs [BK][D] floats.
// KPt holds K transposed for the score product, then the probabilities
// P transposed ([BK][LD]) for the P @ V product.
inline size_t smem_bytes(int D) {
  int kp_rows = D > BK ? D : BK;
  return sizeof(float) * (size_t(D) * LD + size_t(kp_rows) * LD +
                          size_t(BK) * D);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int Hq, int Hkv, int D, int causal, int window,
                 float sm_scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* KPt = Qt + D * LD;
  const int kp_rows = D > BK ? D : BK;
  float* Vs = KPt + kp_rows * LD;

  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // the last q blocks see the most keys: launch them first, so the
  // short blocks fill the tail of the grid
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // q rows ty*4 .. ty*4+3

  const size_t q_row = size_t(Hq) * D;
  const size_t kv_row = size_t(Hkv) * D;
  const T* qb = q + size_t(b) * Sq * q_row + size_t(h) * D;
  const T* kb = k + size_t(b) * Skv * kv_row + size_t(hk) * D;
  const T* vb = v + size_t(b) * Skv * kv_row + size_t(hk) * D;
  T* ob = o + size_t(b) * Sq * q_row + size_t(h) * D;

  // q tile, transposed; rows past Sq are zero and never stored
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    Qt[d * LD + r] = qi < Sq ? to_f32(qb[size_t(qi) * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  // KV-block range: blocks past the diagonal or before the window hold no
  // key any row of this q block may attend to
  int kb_end = (Skv + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, (q0 + BQ - 1) / BK + 1);
  int kb_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kb_begin = lo > 0 ? lo / BK : 0;
  }

  const bool c0 = tx * 4 < D;        // this thread's first 4 output columns
  const bool c1 = 64 + tx * 4 < D;   // and its second 4

  for (int kbi = kb_begin; kbi < kb_end; ++kbi) {
    const int k0 = kbi * BK;
    __syncthreads();  // the previous block's P and V are no longer read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int ki = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (ki < Skv) {
        kv = to_f32(kb[size_t(ki) * kv_row + d]);
        vv = to_f32(vb[size_t(ki) * kv_row + d]);
      }
      KPt[d * LD + r] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&KPt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
    __syncthreads();  // K is read; its buffer now takes P

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qi = q0 + r;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx * 4 + j;
        ok[j] = ki < Skv && (!causal || ki <= qi) &&
                (window <= 0 || ki > qi - window);
        s[i][j] = ok[j] ? s[i][j] * sm_scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // fully masked so far: exp(-inf - -inf) would be NaN
      const float safe_m = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - safe_m);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - safe_m) : 0.f;
        KPt[(tx * 4 + j) * LD + r] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(&KPt[kk * LD + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
      if (c0) v0 = *reinterpret_cast<const float4*>(&Vs[kk * D + tx * 4]);
      if (c1) v1 = *reinterpret_cast<const float4*>(&Vs[kk * D + 64 + tx * 4]);
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = ob + size_t(qi) * q_row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0) store(&orow[tx * 4 + j], acc[i][j] * inv);
      if (c1) store(&orow[64 + tx * 4 + j], acc[i][4 + j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, D,
      causal, window, 1.f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry: dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Skv, int Hq, int Hkv, int D,
                                     int causal, int window, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                                 window, s);
  return launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window,
                       s);
}
