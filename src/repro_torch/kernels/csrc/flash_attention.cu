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
// v and o move only ~12.6 MB (~3.8 us at 3.35 TB/s): the products bound it,
// and only the tensor cores (wgmma) reach their rate; f32 SIMT FMAs (the
// f32 kernel below) reach 67 TFLOP/s at best.
//
// bf16 (the serving path), kernel `tc::flash_tc_kernel`:
// - One CTA per (batch * q-head, q block of 64 * NWG rows), every head's
//   heaviest causal q block launched first.  Warpgroup 0 is the producer:
//   one thread issues TMA loads (cp.async.bulk.tensor) of the Q tile once
//   and of the K and V tiles (BK = 128 keys each) into a ring of STAGES
//   stages, completion signalled on mbarriers; consumers free a stage on a
//   second mbarrier.  The tensor maps cover the model's own (B, S, H, D)
//   layout, so nothing is copied or padded in device memory: a row of D
//   bf16 is one or two boxes of 64 (128 bytes, the 128-byte swizzle span),
//   and columns past D (D = 112, 120) and rows past S read as zeros
//   (out-of-bounds fill).
// - NWG consumer warpgroups of 64 q rows each: S = Q K^T by wgmma (A and B
//   from shared memory, K-major), the masks and the online softmax in base
//   2 in registers on the accumulator's fragment layout, P rounded to bf16
//   in registers as the A operand of O += P V (wgmma, V from shared memory
//   MN-major), f32 accumulation throughout; the epilogue scales by 1/l and
//   stores the columns < D of the rows < Sq.
// - Causal and window bounds cut the KV loop; a warpgroup skips the
//   arithmetic of a block that is masked for all of its rows.
// - 64-row CTAs (NWG = 1) unless 128-row CTAs alone fill every SM (the
//   count is read from the device): at qwen3's 16 heads the 64-row CTAs
//   are faster at every bucket, at zamba2's 32 heads and S = 1024 the
//   128-row ones.
// f32 (exact to 1e-4, which TF32 tensor cores cannot give), kernel
// `simt::flash_fwd_kernel`: f32 SIMT FMAs from f32 shared-memory tiles,
// one CTA of 256 threads per (batch * q-head, 64-row q block), each thread
// a 4x4 block of the score tile and a 4x8 block of the accumulator.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace simt {

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

}  // namespace simt


namespace tc {

constexpr int BK = 128;         // keys per stage
constexpr int STAGES = 2;       // K/V stages in the ring
constexpr int ROW = 128;        // bytes of a box row: 64 bf16, the swizzle span
constexpr int WG = 128;         // threads of a warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; the tiles' 8-row atoms
// are 1024-byte aligned, so the base offset field stays 0
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16) * B (16 x 128), bf16: A and B in
// shared memory, both K-major with the 128-byte swizzle; scale_d = 0
// overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), bf16: A in registers
// (the accumulator's fragment layout), B in shared memory, MN-major with
// the 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16) * B (16 x 128), bf16: A in registers
// (the accumulator's fragment layout), B in shared memory, MN-major with
// the 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// Shared memory: Q [NB][BQ rows][128 B], then K [STAGES][NB][BK][128 B] and
// V likewise, then the mbarriers; 1024 bytes of slack to align the tiles.
template <int NB, int NWG>
constexpr size_t smem_bytes() {
  return 1024 + size_t(NB) * ROW * (64 * NWG + 2 * STAGES * BK) +
         8 * (1 + 2 * STAGES);
}

template <int NB, int NWG>
__global__ void __launch_bounds__(WG * (NWG + 1), 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                int Hkv, int D, int causal, int window, float scale_log2) {
  constexpr int BQ = 64 * NWG;
  constexpr uint32_t Q_BYTES = NB * BQ * ROW;
  constexpr uint32_t KV_BYTES = NB * BK * ROW;  // K or V of one stage
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle is a function of the address bits: align the tiles
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Q_BYTES;
  const uint32_t sv = sk + STAGES * KV_BYTES;
  const uint32_t bar_q = sv + STAGES * KV_BYTES;
  const uint32_t bar_full = bar_q + 8;              // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // the last q blocks see the most keys: every head's last block first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int kb_end = (Skv + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, (q0 + BQ - 1) / BK + 1);
  int kb_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kb_begin = lo > 0 ? lo / BK : 0;
  }
  const int n_blocks = max(kb_end - kb_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NWG * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // ---- producer warpgroup: one thread issues every load ----
    if constexpr (NWG == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    }
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int nb = 0; nb < NB; ++nb)
        tma_load(sq + nb * BQ * ROW, &tq, bar_q, nb * 64, h, q0, b);
      for (int i = 0; i < n_blocks; ++i) {
        const int s = i % STAGES;
        // a fresh barrier counts as released once: the first round passes
        mbar_wait(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * KV_BYTES);
        const int k0 = (kb_begin + i) * BK;
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(sk + s * KV_BYTES + nb * BK * ROW, &tk, bar_full + 8 * s,
                   nb * 64, hk, k0, b);
          tma_load(sv + s * KV_BYTES + nb * BK * ROW, &tv, bar_full + 8 * s,
                   nb * 64, hk, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each ----
  if constexpr (NWG == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  }
  const int cw = threadIdx.x / WG - 1;
  const int t = threadIdx.x % WG;
  const int lane = t % 32;
  const int rw0 = q0 + cw * 64;                 // first row of the group
  const int r_lo = rw0 + (t / 32) * 16 + lane / 4;  // this thread's rows:
  const int r_hi = r_lo + 8;                        // r_lo and r_lo + 8
  const int cq = (lane % 4) * 2;  // its first column in each 8-wide chunk
  const int ksteps = (D + 15) / 16;
  const uint32_t q_tile = sq + cw * 64 * ROW;

  float acc[32 * NB];  // O, 64 x (64 * NB): fragment layout of wgmma
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_blocks; ++i) {
    const int s = i % STAGES;
    const int k0 = (kb_begin + i) * BK;
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    // masked for every row of this group: causal (all keys after the last
    // row) or window (all keys at or before the first row's window edge)
    if ((causal && k0 > rw0 + 63) ||
        (window > 0 && k0 + BK - 1 <= rw0 - window)) {
      mbar_arrive(bar_empty + 8 * s);
      continue;
    }

    // S = Q K^T, 64 x BK
    float sc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    const uint32_t k_tile = sk + s * KV_BYTES;
    fence_regs(sc);
    wgmma_fence();
    for (int ks = 0; ks < ksteps; ++ks) {
      // 16 columns of D: box ks / 4, 32 bytes into its swizzled rows
      const uint32_t col = (ks >> 2), off = (ks & 3) * 32;
      wgmma_ss(sc, sw128_desc(q_tile + col * BQ * ROW + off, 16, 1024),
               sw128_desc(k_tile + col * BK * ROW + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // masks; only blocks at an edge need them
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > rw0) ||
                      (window > 0 && k0 <= rw0 + 63 - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j * 4 + e] * scale_log2;
        if (edge) {
          const int kc = k0 + j * 8 + cq + (e & 1);
          const int qr = e < 2 ? r_lo : r_hi;
          const bool ok = kc < Skv && (!causal || kc <= qr) &&
                          (window <= 0 || kc > qr - window);
          x = ok ? x : -INFINITY;
        }
        sc[j * 4 + e] = x;
      }

    // online softmax, base 2; the 4 threads of a row are lanes 4r .. 4r+3
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[j * 4], sc[j * 4 + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[j * 4 + 2], sc[j * 4 + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // a row masked so far keeps m = -inf: exp2(-inf - 0) = 0, never NaN
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float alpha_lo = ex2(m_lo - base_lo), alpha_hi = ex2(m_hi - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[j * 4] = ex2(sc[j * 4] - base_lo);
      sc[j * 4 + 1] = ex2(sc[j * 4 + 1] - base_lo);
      sc[j * 4 + 2] = ex2(sc[j * 4 + 2] - base_hi);
      sc[j * 4 + 3] = ex2(sc[j * 4 + 3] - base_hi);
      rs_lo += sc[j * 4] + sc[j * 4 + 1];
      rs_hi += sc[j * 4 + 2] + sc[j * 4 + 3];
    }
    // per-thread partial sums; the row's 4 threads add theirs at the end
    l_lo = l_lo * alpha_lo + rs_lo;
    l_hi = l_hi * alpha_hi + rs_hi;
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j) {
      acc[j * 4] *= alpha_lo;
      acc[j * 4 + 1] *= alpha_lo;
      acc[j * 4 + 2] *= alpha_hi;
      acc[j * 4 + 3] *= alpha_hi;
    }

    // P in bf16: the score fragment of keys 16kk .. 16kk+15 is the A
    // fragment of the kk-th k-step
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V's rows are keys (K of the product), D contiguous (N)
    const uint32_t v_tile = sv + s * KV_BYTES;
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, pa[kk],
               sw128_desc(v_tile + kk * 16 * ROW, BK * ROW, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  const size_t q_row = size_t(Hq) * D;
  __nv_bfloat16* ob = o + size_t(b) * Sq * q_row + size_t(h) * D;
#pragma unroll
  for (int j = 0; j < 8 * NB; ++j) {
    const int c = j * 8 + cq;  // D is a multiple of 8: c, c + 1 both fit
    if (c >= D) continue;
    if (r_lo < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_lo * q_row + c) =
          __floats2bfloat162_rn(acc[j * 4] * inv_lo, acc[j * 4 + 1] * inv_lo);
    if (r_hi < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_hi * q_row + c) =
          __floats2bfloat162_rn(acc[j * 4 + 2] * inv_hi,
                                acc[j * 4 + 3] * inv_hi);
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, H, D) bf16 as a 4-d map, innermost first; boxes of 64 columns
// (one swizzle span), one head and `rows` rows
CUresult encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
                int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                                 cuuint64_t(S) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// codes past ENCODE_FAILED are ENCODE_FAILED + the CUresult of the encoder
constexpr int ENCODE_FAILED = 1000;

// Whether each variant (NB, NWG) was opened to its shared memory on each
// device: setting the attribute on every launch costs the device several
// microseconds a call, so it is set once.  File-local, one per library.
constexpr int MAX_DEVICES = 64;
static bool smem_set[4][MAX_DEVICES];

template <int NB, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
           int dev, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NB, NWG>();
  bool& set = smem_set[(NB - 1) * 2 + NWG - 1][dev];
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<NB, NWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    set = true;
  }
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODE_FAILED;
  CUtensorMap mq, mk, mv;
  CUresult r = encode(enc, &mq, q, B, Sq, Hq, D, 64 * NWG);
  if (r == CUDA_SUCCESS) r = encode(enc, &mk, k, B, Skv, Hkv, D, BK);
  if (r == CUDA_SUCCESS) r = encode(enc, &mv, v, B, Skv, Hkv, D, BK);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + int(r);
  const dim3 grid(B * Hq, (Sq + 64 * NWG - 1) / (64 * NWG));
  flash_tc_kernel<NB, NWG><<<grid, WG * (NWG + 1), smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv, D, causal,
      window, 1.4426950408889634f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

// SMs of each device, read once (0 = not read yet)
static int sm_count[MAX_DEVICES];

// q rows per CTA: 128 (two consumer warpgroups) once 128-row CTAs alone
// fill every SM, else 64 for twice the CTAs
template <int NB>
int launch_rows(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                int window, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES) return int(cudaErrorInvalidDevice);
  int& sms = sm_count[dev];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
  }
  if (B * Hq * ((Sq + 127) / 128) >= sms)
    return launch<NB, 2>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window,
                         dev, stream);
  return launch<NB, 1>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window,
                       dev, stream);
}

}  // namespace tc

// Plain C entry: dtype 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor
// cores).  Returns the CUDA error code of the launch (0 = launched), or
// 1000 + the CUresult of a tensor map that could not be encoded.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Skv, int Hq, int Hkv, int D,
                                     int causal, int window, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return simt::launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                               window, s);
  return D > 64 ? tc::launch_rows<2>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                     causal, window, s)
                : tc::launch_rows<1>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                     causal, window, s);
}
