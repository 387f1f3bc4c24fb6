// Fused wire-codec kernels for Hopper (sm_90a): the producer and the
// consumer of the compressed gradient wire, one CUDA block per sketch
// block.
//
// Producer, wire_encode_kernel, replaces the TPU kernel
// src/repro/kernels/sketch_wire.py:encode_pack_quantize_pallas (body
// _wire_encode_kernel). One pass over the gradient block: Count-Sketch
// encode, non-zero bitmap pack, per-block max|sketch|. Its quantize leg
// (TS = int, body _wire_encode_q_kernel) stores the fxp32 wire's
// int32(rint(acc * 2^(M - e))) for the block's exponent e instead of the
// f32 cell; maxabs stays the f32 max|acc|.
//
// Consumer, wire_peel_kernel, replaces
// src/repro/kernels/sketch_wire.py:dequant_peel_unpack_pallas (body
// _wire_peel_kernel). One pass over the aggregated wire payload: bitmap
// unpack, initial degrees, synchronous peel rounds until the block's
// fixpoint (at most `rounds`; the reference always runs `rounds`, and
// rounds after the fixpoint change nothing), and the median-of-3
// estimate for bits still set. Its dequant leg (TS = int,
// body _wire_peel_dq_kernel) loads the int32 aggregate as
// float(q) * 2^(e - M) where the f32 leg loads y.
//
// The legs' scales are exact powers of two written into the exponent
// field (pow2f), never exp2f/ldexpf, and the conversions round half to
// even (__float2int_rn, __int2float_rn), as rint and the int-to-float
// cast do: the quantize leg equals "f32 leg, then FixedPointWire.encode"
// and the dequant leg "FixedPointWire.decode, then f32 leg" bit for bit
// on any input. Each adds one multiply and one conversion per sketch
// cell and 4 bytes of exponent per block, so the bounds below hold.
//
// Bound. Both are bound by device memory. Per block of G*c elements the
// producer reads the block (4Gc bytes) and writes the sketch, the words
// and one float (4*rows*c + Gc/8 + 4 bytes): 139 KB at G=60, c=512,
// rows=6. The consumer reads the sketch and the words and writes values
// and an int8 residual (5Gc bytes): 170 KB. The arithmetic is ~3Gc adds
// per pass, about 100 times below the bytes at the card's rates.
//
// Design. The producer stages the x block (120 KiB) in shared memory and
// reads it three times from there, so device memory sees each input byte
// once. The consumer keeps what its rounds touch in shared memory, 63,580
// B a block at G=60, c=512, rows=6, so three 512-thread blocks (48 warps)
// share an SM and one block's loads and stores overlap another's rounds:
// y, the degrees, this round's per-cell contribution count and single
// value, the input, current and just-peeled bits, the rotations and the
// hash tables. Peeled values go straight to the output plane, where the
// rounds read them back (L2), instead of a 120 KiB shared plane. Its work
// follows the set bits, not the block: degrees start from integer atomics
// over the set bits, the gather walks words and their set bits, the
// scatter visits only the cells a peel touched, and each block stops at
// its own fixpoint (sketch_tile.cuh:peel_block). A geometry whose state
// does not fit shared memory (the lossless profile, rows=60 at ratio 2:
// ~487 KiB for the consumer) runs the same code with the per-cell planes
// in device-memory scratch and x read where it lies. Every sketch cell
// (r, m) sums its contributions in the reference's (i, j) order from 0.0
// (the producer's owner thread over a per-row list of the (i, j) pairs
// hashing to row r; the consumer's owner where one value arrives, a warp
// over that list where several do). There are no float atomics, so a run
// repeats bit for bit, and on dyadic inputs the result equals the plain
// version's exactly. The bitmap word w, bit k is element 32w+k of the
// block: one __ballot_sync per warp over 32 consecutive elements.
//
// The owner-sum encode and the peel rounds live in sketch_tile.cuh, shared
// with the standalone encode and peel of sketch_codec.cu. The TPU kernels'
// one-hot plan-matrix contraction, VMEM budgets and multi-block grid cells
// are not carried over. Several blocks per CUDA block, cp.async/TMA
// staging and the producer's occupancy (one 512-thread block an SM) are
// later work.
//
// Interface: plain C, loaded with ctypes. Each function returns the
// cudaError_t of the launch (0 on success). Words are uint32 bits (the
// PyTorch side stores them in int32 tensors).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sketch_tile.cuh"

using namespace sketch_tile;

namespace {

// Shared-memory layout of the producer: x block (when kResident), then
// rotations. TS is the sketch's wire type: float, or int for the
// quantize leg (exps and mbits are read only then).
template <bool kResident, typename TS>
__global__ void __launch_bounds__(kThreads)
wire_encode_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ ent,
                   const float* __restrict__ ent_sign,
                   TS* __restrict__ sketch, uint32_t* __restrict__ words,
                   float* __restrict__ maxabs,
                   const int* __restrict__ exps, int mbits, int group,
                   int lanes, int rows, uint32_t salt) {
  extern __shared__ float smem[];
  __shared__ float warp_max[kThreads / 32];
  const int n = group * lanes;
  const long long blk = blockIdx.x;
  const float* xb = x + blk * n;
  const float* xs;
  int* rot;
  if constexpr (kResident) {
    xs = smem;
    rot = reinterpret_cast<int*>(smem + n);
  } else {
    xs = xb;
    rot = reinterpret_cast<int*>(smem);
  }

  block_rotations(rot, (uint32_t)ids[blk], group, lanes, salt);
  uint32_t* wb = words + blk * (n / 32);
  // n % 32 == 0 and blockDim % 32 == 0: each warp covers whole words.
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float v = xb[e];
    if constexpr (kResident) smem[e] = v;
    const unsigned bits = __ballot_sync(0xffffffffu, v != 0.0f);
    if ((threadIdx.x & 31) == 0) wb[e >> 5] = bits;
  }
  __syncthreads();

  float s = 1.0f;
  if constexpr (std::is_same<TS, int>::value) s = pow2f(mbits - exps[blk]);
  float mx = encode_cells(xs, rot, row_ptr, ent, ent_sign,
                          sketch + blk * rows * lanes, s, lanes, rows);
  mx = block_max(mx, warp_max);
  if (threadIdx.x == 0) maxabs[blk] = mx;
}

// The consumer: its state as sketch_tile::peel_setup lays it out (y then
// holds the dequantized floats on the int leg). TS as in the producer.
// block_rounds, where not NULL, takes each block's rounds run.
template <bool kResident, typename TS>
__global__ void __launch_bounds__(kPeelThreads, kPeelBlocksPerSM)
wire_peel_kernel(const TS* __restrict__ sketch,
                 const uint32_t* __restrict__ words,
                 const int* __restrict__ ids, const int* __restrict__ row_ptr,
                 const int* __restrict__ ent, const int* __restrict__ hrow,
                 const float* __restrict__ sign,
                 const int* __restrict__ exps, int mbits,
                 float* __restrict__ values, int8_t* __restrict__ residual,
                 int* __restrict__ block_rounds, float* state, int group,
                 int lanes, int rows, int rounds, uint32_t salt) {
  extern __shared__ float smem[];
  const int n = group * lanes, nw = n / 32, ns = rows * lanes;
  const long long blk = blockIdx.x;
  const PeelPlanes p =
      peel_setup<kResident>(smem, state, blk, (uint32_t)ids[blk], row_ptr,
                            ent, hrow, sign, group, lanes, rows, salt);
  float s = 1.0f;
  if constexpr (std::is_same<TS, int>::value) s = pow2f(exps[blk] - mbits);
  load_sketch(p.y, sketch + blk * ns, ns, s);
  const uint32_t* wg = words + blk * nw;
  if ((nw & 3) == 0 && ((reinterpret_cast<uintptr_t>(wg) |
                         reinterpret_cast<uintptr_t>(p.org)) & 15) == 0) {
    for (int k = threadIdx.x; k < nw / 4; k += blockDim.x) {
      const uint4 v = reinterpret_cast<const uint4*>(wg)[k];
      reinterpret_cast<uint4*>(p.org)[k] = v;
      reinterpret_cast<uint4*>(p.bw)[k] = v;
    }
  } else {
    for (int w = threadIdx.x; w < nw; w += blockDim.x) p.org[w] = p.bw[w] = wg[w];
  }
  __syncthreads();

  const int done =
      peel_block(p, values + blk * n, residual + blk * n, n, lanes, rows, rounds);
  if (block_rounds != nullptr && threadIdx.x == 0) block_rounds[blk] = done;
}

template <bool kResident, typename TS>
int launch_encode(const float* x, const int* ids, const int* row_ptr,
                  const int* ent, const float* ent_sign, TS* sketch,
                  uint32_t* words, float* maxabs, const int* exps, int mbits,
                  int nb, int group, int lanes, int rows, uint32_t salt,
                  size_t smem, cudaStream_t stream) {
  int err = set_smem((const void*)wire_encode_kernel<kResident, TS>, smem);
  if (err) return err;
  if (nb > 0)
    wire_encode_kernel<kResident, TS><<<nb, kThreads, smem, stream>>>(
        x, ids, row_ptr, ent, ent_sign, sketch, words, maxabs, exps, mbits,
        group, lanes, rows, salt);
  return (int)cudaGetLastError();
}

template <bool kResident, typename TS>
int launch_peel(const TS* sketch, const uint32_t* words, const int* ids,
                const int* row_ptr, const int* ent, const int* hrow,
                const float* sign, const int* exps, int mbits, float* values,
                int8_t* residual, int* block_rounds, float* state, int nb,
                int group, int lanes, int rows, int rounds, uint32_t salt,
                size_t smem, cudaStream_t stream) {
  int err = set_smem((const void*)wire_peel_kernel<kResident, TS>, smem);
  if (err) return err;
  if (nb > 0)
    wire_peel_kernel<kResident, TS><<<nb, kPeelThreads, smem, stream>>>(
        sketch, words, ids, row_ptr, ent, hrow, sign, exps, mbits, values,
        residual, block_rounds, state, group, lanes, rows, rounds, salt);
  return (int)cudaGetLastError();
}

// Each kernel of this file with its block size: 0/1 the producer's f32 and
// quantize legs, 2/3 the consumer's f32 and dequant legs.
const void* kernel_of(int kind, int resident, int* threads) {
  *threads = kind < 2 ? kThreads : kPeelThreads;
  switch (kind * 2 + (resident ? 1 : 0)) {
    case 0: return (const void*)wire_encode_kernel<false, float>;
    case 1: return (const void*)wire_encode_kernel<true, float>;
    case 2: return (const void*)wire_encode_kernel<false, int>;
    case 3: return (const void*)wire_encode_kernel<true, int>;
    case 4: return (const void*)wire_peel_kernel<false, float>;
    case 5: return (const void*)wire_peel_kernel<true, float>;
    case 6: return (const void*)wire_peel_kernel<false, int>;
    case 7: return (const void*)wire_peel_kernel<true, int>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block may opt in to on `device`, or a
// negative cudaError_t.
int sketch_wire_max_smem(int device) { return max_smem_optin(device); }

// Dynamic shared memory of each kernel; `resident` keeps the x block (the
// producer) or y, the degrees and the contributions (the consumer) there too.
size_t sketch_wire_encode_smem(int group, int lanes, int resident) {
  return encode_smem(group, lanes, resident);
}

size_t sketch_wire_peel_smem(int group, int lanes, int rows, int resident) {
  return peel_smem(group, lanes, rows, resident);
}

// Blocks of kernel `kind` (see kernel_of) that one SM of the current
// device holds at once at this geometry, or a negative cudaError_t.
int sketch_wire_occupancy(int kind, int group, int lanes, int rows,
                          int resident) {
  int threads = 0;
  const void* fn = kernel_of(kind, resident, &threads);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  const size_t smem = kind < 2 ? encode_smem(group, lanes, resident)
                               : peel_smem(group, lanes, rows, resident);
  return occupancy(fn, threads, smem);
}

// exps == NULL: the f32 wire, `sketch` is float. Otherwise the quantize
// leg: (nb,) int32 exponents, mantissa bits `mbits`, `sketch` is int32.
int sketch_wire_encode(const float* x, const int* ids, const int* row_ptr,
                       const int* ent, const float* ent_sign, void* sketch,
                       int* words, float* maxabs, const int* exps, int nb,
                       int group, int lanes, int rows, int mbits,
                       int resident, unsigned salt, void* stream) {
  const size_t smem = sketch_wire_encode_smem(group, lanes, resident);
  uint32_t* w = reinterpret_cast<uint32_t*>(words);
  cudaStream_t st = (cudaStream_t)stream;
  if (exps == nullptr) {
    float* sk = static_cast<float*>(sketch);
    return resident
               ? launch_encode<true>(x, ids, row_ptr, ent, ent_sign, sk, w,
                                     maxabs, exps, mbits, nb, group, lanes,
                                     rows, salt, smem, st)
               : launch_encode<false>(x, ids, row_ptr, ent, ent_sign, sk, w,
                                      maxabs, exps, mbits, nb, group, lanes,
                                      rows, salt, smem, st);
  }
  int* sk = static_cast<int*>(sketch);
  return resident
             ? launch_encode<true>(x, ids, row_ptr, ent, ent_sign, sk, w,
                                   maxabs, exps, mbits, nb, group, lanes,
                                   rows, salt, smem, st)
             : launch_encode<false>(x, ids, row_ptr, ent, ent_sign, sk, w,
                                    maxabs, exps, mbits, nb, group, lanes,
                                    rows, salt, smem, st);
}

// state (nb, 4, rows, lanes) f32 is scratch for resident == 0 and unused
// otherwise; block_rounds is NULL or (nb,) int32, each block's rounds run.
// exps == NULL: `sketch` is the f32 aggregate; otherwise the int32 fxp32
// aggregate, dequantized with (nb,) int32 exponents and mantissa bits
// `mbits`.
int sketch_wire_peel(const void* sketch, const int* words, const int* ids,
                     const int* row_ptr, const int* ent, const int* hrow,
                     const float* sign, const int* exps, float* values,
                     signed char* residual, int* block_rounds, float* state,
                     int nb, int group, int lanes, int rows, int rounds,
                     int mbits, int resident, unsigned salt, void* stream) {
  const size_t smem = sketch_wire_peel_smem(group, lanes, rows, resident);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  int8_t* res = reinterpret_cast<int8_t*>(residual);
  cudaStream_t st = (cudaStream_t)stream;
  if (exps == nullptr) {
    const float* sk = static_cast<const float*>(sketch);
    return resident
               ? launch_peel<true>(sk, w, ids, row_ptr, ent, hrow, sign, exps,
                                   mbits, values, res, block_rounds, state, nb,
                                   group, lanes, rows, rounds, salt, smem, st)
               : launch_peel<false>(sk, w, ids, row_ptr, ent, hrow, sign, exps,
                                    mbits, values, res, block_rounds, state, nb,
                                    group, lanes, rows, rounds, salt, smem, st);
  }
  const int* sk = static_cast<const int*>(sketch);
  return resident
             ? launch_peel<true>(sk, w, ids, row_ptr, ent, hrow, sign, exps,
                                 mbits, values, res, block_rounds, state, nb,
                                 group, lanes, rows, rounds, salt, smem, st)
             : launch_peel<false>(sk, w, ids, row_ptr, ent, hrow, sign, exps,
                                  mbits, values, res, block_rounds, state, nb,
                                  group, lanes, rows, rounds, salt, smem, st);
}

}  // extern "C"
