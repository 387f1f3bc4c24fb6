// Device code shared by every sketch kernel: the hash mixer and block
// rotations, the owner-sum encode of one block and the peel of one block.
//
// The fused wire kernels (sketch_wire.cu) and the standalone encode and
// peel kernels (sketch_codec.cu) run exactly this code, as the reference's
// fused Pallas kernels share encode_tile and peel_tile with the plain ones
// (src/repro/kernels/sketch_encode.py, sketch_peel.py): the standalone
// sketch equals the fused producer's, and the standalone peel the fused
// consumer's on the same bits, bit for bit on any input.
//
// Layout of a block: element e = i * lanes + l of batch i, lane l;
// n = group * lanes elements; bit word w holds elements 32w .. 32w + 31,
// bit k for element 32w + k, and the bits past n in the last word are 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sketch_tile {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// rot_j(i, blk) of pair t = 3i + j, as
// src/repro/core/hashing.py:block_rotations.
__device__ __forceinline__ int rotation(uint32_t blk, int t, int lanes,
                                        uint32_t salt) {
  return (int)(mix32(blk * 0x01000193u + (uint32_t)t + salt) %
               (uint32_t)lanes);
}

// rot[3i + j] = rot_j(i, blk).
__device__ __forceinline__ void block_rotations(int* rot, uint32_t blk,
                                                int group, int lanes,
                                                uint32_t salt) {
  for (int t = threadIdx.x; t < group * 3; t += blockDim.x)
    rot[t] = rotation(blk, t, lanes, salt);
}

// Exact float 2^k for k in [-126, 127] (net/fixedpoint.py:pow2).
__device__ __forceinline__ float pow2f(int k) {
  return __int_as_float((k + 127) << 23);
}

// A sketch cell as the wire carries it: f32, or the fxp32 int32 at the
// block's scale s (2^(M-e) to store, 2^(e-M) to load).
__device__ __forceinline__ void store_cell(float* p, float acc, float) {
  *p = acc;
}
__device__ __forceinline__ void store_cell(int* p, float acc, float s) {
  *p = __float2int_rn(acc * s);
}
__device__ __forceinline__ float cell_value(float v, float) { return v; }
__device__ __forceinline__ float cell_value(int q, float s) {
  return __int2float_rn(q) * s;
}

// Max of v over the block; every thread calls it, and warp 0 holds the
// result. scratch holds one float a warp.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// ---------------------------------------------------------------------
// The owner-sum encode of one block, streamed.
//
// Every sketch cell (r, m) is owned by one thread, which sums its terms
// g_j(i) * x[i][(m - rot_j(i, blk)) mod c] over the (i, j) pairs with
// h_j(i) == r, in increasing (i, j) order, from +0.0: no atomics, so a run
// repeats bit for bit and equals the plain version's order. The block's
// batch rows stream through a ring of kEncStages shared-memory stages,
// chunk_rows rows a chunk, filled by cp.async (16 bytes a copy where x
// and the lanes allow it, else 4) while earlier chunks are summed. The
// pairs are listed per (chunk, row), each list in (i, j) order, so the
// lists of one row over the chunks in order are that row's whole list:
// each cell adds its terms in the same order as one pass over the block
// would. An owner thread keeps kEncLanes columns of every row in
// registers (up to kRegRows = 8 rows, unrolled) or, for more rows or
// lanes, in a plane of rows * lanes floats (shared memory where it fits,
// else the block's slice of a device-memory scratch). The fused producer
// also takes the bitmap words from each landed chunk, one ballot per warp
// over 32 elements, and stores them to device memory as they complete.
// ---------------------------------------------------------------------

constexpr int kEncStages = 3;       // chunks in the ring
constexpr int kEncLanes = 2;        // columns an owner thread keeps
constexpr int kEncMaxThreads = 512;

// Threads of an encode block at `lanes`: kEncLanes columns a thread, in
// whole warps, at most kEncMaxThreads (256 at c = 512).
__host__ __device__ inline int encode_threads(int lanes) {
  const int t = ((lanes + kEncLanes - 1) / kEncLanes + 31) / 32 * 32;
  return t < kEncMaxThreads ? t : kEncMaxThreads;
}

// Blocks of kEncMaxThreads an SM that the registers must allow
// (__launch_bounds__): 64 registers a thread, four blocks of 256 at
// c = 512.
constexpr int kEncMinBlocks = 2;

// Rows of accumulators a thread keeps in registers (8), or 0 for the
// plane variant.
__host__ __device__ inline int encode_reg_rows(int lanes, int rows) {
  return rows <= 8 && lanes <= kEncLanes * kEncMaxThreads ? 8 : 0;
}

// The shared memory of an encode block, in order: the ring, the pairs
// with this block's rotations (8 B each), the per-(chunk, row) list
// offsets, a float a warp for the max and the two words the producer
// carries across a chunk boundary, and the plane where it lies in shared
// memory. 50,924 B at G = 60, c = 512, rows = 6.
struct EncodeShape {
  int group, lanes, rows, chunk_rows, nchunks, nw;
  __host__ __device__ EncodeShape(int g, int c, int r, int k, bool words)
      : group(g), lanes(c), rows(r), chunk_rows(k), nchunks((g + k - 1) / k),
        nw(words ? (g * c + 31) / 32 : 0) {}
  __host__ __device__ size_t rec() const {
    return (4 * (size_t)kEncStages * chunk_rows * lanes + 15) / 16 * 16;
  }
  __host__ __device__ size_t cptr() const {
    return rec() + 8 * 3 * (size_t)group;
  }
  __host__ __device__ size_t scratch() const {
    return cptr() + 4 * ((size_t)nchunks * rows + 1);
  }
  __host__ __device__ size_t plane() const { return scratch() + 4 * (32 + 2); }
  __host__ __device__ size_t bytes(bool plane_in_smem) const {
    return plane() + (plane_in_smem ? 4 * (size_t)rows * lanes : 0);
  }
};

// Bytes of dynamic shared memory an encode needs: the plane counts where
// the geometry takes the plane variant and `resident` keeps it there.
inline size_t encode_smem(int group, int lanes, int rows, int chunk_rows,
                          int resident) {
  return EncodeShape(group, lanes, rows, chunk_rows, false)
      .bytes(resident && encode_reg_rows(lanes, rows) == 0);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A pair of the encode as sum_chunk reads it, for pair t = 3i + j, li =
// i mod chunk_rows its row in the chunk: x = (li*c - rot_j(i)) * 4, and
// y = li*c * 4 - 2 - neg with neg = 1 where g_j(i) = -1. Column m reads
// the stage at byte m*4 + x, plus c*4 where that falls before the row's
// start li*c*4 (the rotation wraps): both are multiples of 4, so a < y
// tests it, and bit 0 of y is neg.
__device__ __forceinline__ int2 pair_record(int li, int rot, int c, float g) {
  return make_int2(4 * (li * c - rot),
                   4 * li * c - 2 - (__float_as_int(g) < 0 ? 1 : 0));
}
__device__ __forceinline__ float pair_sign(int y) {
  return __int_as_float(0x3f800000 | ((uint32_t)y << 31));
}

// Sum one chunk (stage xs) into the owned cells, row by row, each row's
// pairs rec[cp[r] .. cp[r + 1]) in (i, j) order (pair_record).
template <int kRegRows, int kR>
__device__ __forceinline__ void sum_chunk(float (&acc)[kR][kEncLanes],
                                          const int (&colb)[kEncLanes],
                                          float* pl, const float* xs,
                                          const int2* rec, const int* cp,
                                          int rows, int c) {
  const char* xb = reinterpret_cast<const char*>(xs);
  const int cb = 4 * c;
  if constexpr (kRegRows > 0) {
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      if (r < rows) {
        const int q1 = cp[r + 1];
#pragma unroll 2
        for (int q = cp[r]; q < q1; ++q) {
          const int2 e = rec[q];
          const float sg = pair_sign(e.y);
#pragma unroll
          for (int j = 0; j < kEncLanes; ++j) {
            int a = colb[j] + e.x;
            if (a < e.y) a += cb;
            acc[r][j] += sg * *reinterpret_cast<const float*>(xb + a);
          }
        }
      }
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const int q1 = cp[r + 1];
      for (int q = cp[r]; q < q1; ++q) {
        const int2 e = rec[q];
        const float sg = pair_sign(e.y);
        for (int m = threadIdx.x; m < c; m += blockDim.x) {
          int a = 4 * m + e.x;
          if (a < e.y) a += cb;
          pl[r * c + m] += sg * *reinterpret_cast<const float*>(xb + a);
        }
      }
    }
  }
}

// The bitmap words of chunk k (elements e0 .. e0 + ne of the block's n,
// in stage xs) into the block's words in device memory. Every lane of a
// warp takes part in each ballot: T % 32 == 0 and the loops run to
// multiples of 32. Where e0 and ne are multiples of 32 (c % 32 == 0) a
// chunk holds whole words: a warp takes four at a time, its four loads
// issued before its ballots, and four lanes store them. Otherwise the
// word that spans a chunk boundary keeps the earlier chunk's bits in
// carry[k & 1] (shared memory) until the later chunk adds its own and
// stores it: two slots, so that one step's read and the next step's write
// lie a barrier apart.
__device__ __forceinline__ void chunk_words(uint32_t* wout, uint32_t* carry,
                                            const float* xs, int k, int e0,
                                            int ne, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (((e0 | ne) & 31) == 0) {
    uint32_t* wc = wout + (e0 >> 5);
    for (int e = 128 * warp; e < ne; e += 128 * nwarps) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = e + 32 * j < ne ? xs[e + 32 * j + lane] : 0.0f;
      uint32_t b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = __ballot_sync(0xffffffffu, v[j] != 0.0f);
      if (lane < 4 && e + 32 * lane < ne)
        wc[(e >> 5) + lane] =
            lane == 0 ? b[0] : lane == 1 ? b[1] : lane == 2 ? b[2] : b[3];
    }
  } else {
    const int end = e0 + ne;
    for (int e = (e0 & ~31) + (int)threadIdx.x; e < ((end + 31) & ~31);
         e += blockDim.x) {
      const uint32_t b = __ballot_sync(
          0xffffffffu, e >= e0 && e < end && xs[e - e0] != 0.0f);
      if (lane == 0) {  // e is the word's first element
        const uint32_t w = e < e0 ? b | carry[k & 1] : b;
        if (e + 32 <= end || end == n)
          wout[e >> 5] = w;
        else
          carry[(k + 1) & 1] = w;
      }
    }
  }
}

// Encode block `blk` (id `id`) of x into its sketch cells (scale s, see
// store_cell), and where `wout` is not NULL its bitmap words, where
// `maxabs` is not NULL its max|cell|, where `phase` is not NULL thread 0's
// clock64 cycles waiting on chunks, summing, and in all. `cptr`, `ent` and
// `ent_sign` list the pairs t = 3i + j per (chunk, row) in (i, j) order;
// `plane` is NULL (the plane, if any, in shared memory) or a scratch of
// rows * lanes floats a block. All threads call it.
template <int kRegRows, typename TS>
__device__ __forceinline__ void encode_block(
    unsigned char* smem, const float* __restrict__ x, long long blk,
    uint32_t id, const int* __restrict__ cptr_g, const int* __restrict__ ent,
    const float* __restrict__ ent_sign, TS* __restrict__ sketch,
    uint32_t* __restrict__ wout, float* __restrict__ maxabs, float s,
    float* plane_g, long long* __restrict__ phase, const EncodeShape& sh,
    uint32_t salt) {
  const int G = sh.group, c = sh.lanes, rows = sh.rows, K = sh.chunk_rows;
  const int nch = sh.nchunks, nw = sh.nw, stage = K * c;
  const int tid = threadIdx.x, T = blockDim.x;
  float* ring = reinterpret_cast<float*>(smem);
  int2* rec = reinterpret_cast<int2*>(smem + sh.rec());
  int* cptr = reinterpret_cast<int*>(smem + sh.cptr());
  float* warp_max = reinterpret_cast<float*>(smem + sh.scratch());
  uint32_t* carry = reinterpret_cast<uint32_t*>(warp_max + 32);
  uint32_t* wblk = nw ? wout + blk * nw : nullptr;
  float* pl = plane_g != nullptr ? plane_g + blk * rows * c
                                 : reinterpret_cast<float*>(smem + sh.plane());
  const float* xb = x + blk * G * c;
  const bool stamp = phase != nullptr && tid == 0;
  long long t0 = 0, tm = 0, t_wait = 0, t_sum = 0;
  if (stamp) t0 = clock64();

  // Chunk k (batch rows kK .. kK + K) into stage k % kEncStages; one
  // commit group a call, empty past the last chunk, so the groups count
  // the chunks.
  const bool vec = ((reinterpret_cast<uintptr_t>(x) & 15) | (c & 3)) == 0;
  auto fill = [&](int k) {
    if (k < nch) {
      const int i0 = k * K, ne = (G - i0 < K ? G - i0 : K) * c;
      float* dst = ring + (k % kEncStages) * stage;
      const float* src = xb + (long long)i0 * c;
      if (vec) {
        for (int e = 4 * tid; e < ne; e += 4 * T) cp_async16(dst + e, src + e);
      } else {
        for (int e = tid; e < ne; e += T) cp_async4(dst + e, src + e);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < kEncStages - 1; ++k) fill(k);

  // The pairs with this block's rotations, as sum_chunk reads them.
  for (int q = tid; q < 3 * G; q += T) {
    const int t = ent[q];
    rec[q] = pair_record((t / 3) % K, rotation(id, t, c, salt), c,
                         ent_sign[q]);
  }
  for (int q = tid; q <= nch * rows; q += T) cptr[q] = cptr_g[q];

  // The columns this thread owns, as byte offsets (clamped in range: a
  // column past the lanes sums a copy of the last one and stores nothing).
  int colb[kEncLanes];
#pragma unroll
  for (int j = 0; j < kEncLanes; ++j) colb[j] = 4 * min(tid + j * T, c - 1);
  constexpr int kR = kRegRows > 0 ? kRegRows : 1;
  float acc[kR][kEncLanes];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kEncLanes; ++j) acc[r][j] = 0.0f;
  if constexpr (kRegRows == 0) {
    for (int m = tid; m < c; m += T)
      for (int r = 0; r < rows; ++r) pl[r * c + m] = 0.0f;
  }

  // Step k: wait for chunk k, whose barrier also frees the stage chunk
  // k - 1 was read from; refill that stage with chunk k + kEncStages - 1;
  // take chunk k's words and sum it. Two chunks stay in flight.
  for (int k = 0; k < nch; ++k) {
    if (stamp) tm = clock64();
    cp_async_wait<kEncStages - 2>();
    __syncthreads();
    if (stamp) t_wait += clock64() - tm;
    fill(k + kEncStages - 1);
    const float* xs = ring + (k % kEncStages) * stage;
    if (nw) {
      const int kc = G - k * K < K ? G - k * K : K;
      chunk_words(wblk, carry, xs, k, k * K * c, kc * c, G * c);
    }
    if (stamp) tm = clock64();
    sum_chunk<kRegRows>(acc, colb, pl, xs, rec, cptr + k * rows, rows, c);
    if (stamp) t_sum += clock64() - tm;
  }

  // Store the cells (coalesced: neighbouring threads own neighbouring
  // columns).
  TS* out = sketch + blk * rows * c;
  float mx = 0.0f;
  if constexpr (kRegRows > 0) {
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < kEncLanes; ++j) {
          const int m = tid + j * T;
          if (m < c) {
            store_cell(out + r * c + m, acc[r][j], s);
            mx = fmaxf(mx, fabsf(acc[r][j]));
          }
        }
      }
    }
  } else {
    for (int m = tid; m < c; m += T)
      for (int r = 0; r < rows; ++r) {
        const float v = pl[r * c + m];
        store_cell(out + r * c + m, v, s);
        mx = fmaxf(mx, fabsf(v));
      }
  }
  if (maxabs != nullptr) {
    mx = block_max(mx, warp_max);
    if (tid == 0) maxabs[blk] = mx;
  }
  if (stamp) {
    phase[3 * blk] = t_wait;
    phase[3 * blk + 1] = t_sum;
    phase[3 * blk + 2] = clock64() - t0;
  }
}

// Threads of a peel block, and the peel blocks one SM holds at once:
// three blocks of 512 (48 warps) at 63,580 B of shared memory each.
constexpr int kPeelThreads = 512;
constexpr int kPeelBlocksPerSM = 3;

// Where a peel keeps its state. Four planes of one 32-bit value a sketch
// cell: y (the sketch), d (the degrees), and this round's contributions
// to each cell, hit (how many) and hv (the value of a single one). They
// lie in shared memory (kResident) or in the block's slice of a
// device-memory scratch of 4 * rows * lanes floats a block, in the same
// order. Shared memory always holds the input
// bits org, the current bits bw and the bits peeled this round pk (nw =
// ceil(n / 32) words each), the block's rotations, and the hash tables
// staged once a block: hrow[t] = h_j(i), sign[t] = g_j(i) (t = 3i + j),
// and per sketch row r the t hashing to it in (i, j) order,
// ent[row_ptr[r] .. row_ptr[r + 1]).
struct PeelPlanes {
  float* y;
  int* d;
  uint32_t* hit;
  float* hv;
  uint32_t* org;
  uint32_t* bw;
  uint32_t* pk;
  int* rot;
  int* hrow;
  float* sign;
  int* ent;
  int* row_ptr;
};

// Bytes of dynamic shared memory a peel needs (the layout above): 16 per
// cell when resident, then 12 per word of bits, 16 per (i, j) pair and the
// row offsets. 63,580 B at G = 60, c = 512, rows = 6.
inline size_t peel_smem(int group, int lanes, int rows, int resident) {
  const size_t n = (size_t)group * lanes, ns = (size_t)rows * lanes;
  return (resident ? 16 * ns : 0) + 12 * ((n + 31) / 32) +
         16 * 3 * (size_t)group + 4 * ((size_t)rows + 1);
}

// Lays the planes out, computes the block's rotations, stages the hash
// tables and zeroes d and hit. The caller loads y, org and bw (the same
// words), then syncs.
template <bool kResident>
__device__ __forceinline__ PeelPlanes peel_setup(
    float* smem, float* state, long long blk, uint32_t id,
    const int* __restrict__ row_ptr, const int* __restrict__ ent,
    const int* __restrict__ hrow, const float* __restrict__ sign, int group,
    int lanes, int rows, uint32_t salt) {
  const int n = group * lanes, ns = rows * lanes, nw = (n + 31) / 32;
  const int g3 = 3 * group;
  // Barriers order device-memory accesses within a block as they do
  // shared ones, atomics included, so the rounds hold as written in
  // either place.
  float* cells = kResident ? smem : state + blk * 4 * ns;
  PeelPlanes p;
  p.y = cells;
  p.d = reinterpret_cast<int*>(p.y + ns);
  p.hit = reinterpret_cast<uint32_t*>(p.d + ns);
  p.hv = reinterpret_cast<float*>(p.hit + ns);
  p.org = reinterpret_cast<uint32_t*>(kResident ? p.hv + ns : smem);
  p.bw = p.org + nw;
  p.pk = p.bw + nw;
  p.rot = reinterpret_cast<int*>(p.pk + nw);
  p.hrow = p.rot + g3;
  p.sign = reinterpret_cast<float*>(p.hrow + g3);
  p.ent = reinterpret_cast<int*>(p.sign + g3);
  p.row_ptr = p.ent + g3;
  block_rotations(p.rot, id, group, lanes, salt);
  for (int t = threadIdx.x; t < g3; t += blockDim.x) {
    p.hrow[t] = hrow[t];
    p.sign[t] = sign[t];
    p.ent[t] = ent[t];
  }
  for (int r = threadIdx.x; r <= rows; r += blockDim.x) p.row_ptr[r] = row_ptr[r];
  for (int c = threadIdx.x; c < ns; c += blockDim.x) {
    p.d[c] = 0;
    p.hit[c] = 0u;
  }
  return p;
}

// y[0 .. ns) = the block's sketch cells as floats, 16 bytes a load where
// both sides allow it.
template <typename TS>
__device__ __forceinline__ void load_sketch(float* y, const TS* src, int ns,
                                            float s) {
  if ((ns & 3) == 0 && ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0) {
    using V = typename std::conditional<std::is_same<TS, int>::value, int4,
                                        float4>::type;
    const V* sv = reinterpret_cast<const V*>(src);
    float4* yv = reinterpret_cast<float4*>(y);
    for (int k = threadIdx.x; k < ns / 4; k += blockDim.x) {
      const V v = sv[k];
      yv[k] = make_float4(cell_value(v.x, s), cell_value(v.y, s),
                          cell_value(v.z, s), cell_value(v.w, s));
    }
  } else {
    for (int k = threadIdx.x; k < ns; k += blockDim.x)
      y[k] = cell_value(src[k], s);
  }
}

// Sketch cell of pair t = 3i + j for lane l of batch i.
__device__ __forceinline__ int pair_cell(const PeelPlanes& p, int t, int l,
                                         int lanes) {
  int col = l + p.rot[t];
  if (col >= lanes) col -= lanes;
  return p.hrow[t] * lanes + col;
}

// The peel of one block, after peel_setup, the loads of y, org and bw and
// a barrier: initial degrees, synchronous peel rounds until the block's
// fixpoint or `rounds`, and the median-of-3 estimate for bits still set;
// an element whose input bit is clear gets 0. Writes vout (n) and rout
// (n), 16 and 4 bytes a store where n % 4 == 0; returns the rounds run
// (gathers, the last of which peeled nothing where the fixpoint came
// first).
//
// Each round is a gather and a scatter. The gather peels every set bit
// with a singleton cell on the round-start y and d, takes its value v from
// the first such hash j, writes it to vout, and for each of its three
// cells (pair t = 3i + j) counts one in hit and stores sign[t] * v into
// hv. The scatter visits only the cells that took a contribution: the
// owner of a cell of one subtracts 0.0 + hv, the owner-sum of a single
// term (hv holds the last store where there were several, and is not read
// then); a warp sums a cell of several in the
// reference's (i, j) order, as the owner-sum does, from the bits peeled
// this round (pk) and the values in vout. No float is summed by atomics.
// A round that peels nothing changes nothing, so a block that reaches its
// fixpoint leaves the loop: every output bit is what all `rounds` rounds
// would give.
__device__ __forceinline__ int peel_block(const PeelPlanes& p, float* vout,
                                          int8_t* rout, int n, int lanes,
                                          int rows, int rounds) {
  const int nw = (n + 31) >> 5, ns = rows * lanes, lane = threadIdx.x & 31;

  // Initial degrees: each set bit adds one to its three cells (integer
  // atomics: the same counts in any order).
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    for (uint32_t b = p.bw[w]; b; b &= b - 1) {
      const int e = (w << 5) + __ffs(b) - 1, i = e / lanes, l = e - i * lanes;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        atomicAdd(&p.d[pair_cell(p, 3 * i + j, l, lanes)], 1);
    }
  }
  __syncthreads();

  int done = 0;
  while (done < rounds) {
    // Gather on the round-start y and d.
    bool any = false;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      const uint32_t b = p.bw[w];
      uint32_t pw = 0;
      for (uint32_t rest = b; rest; rest &= rest - 1) {
        const int k = __ffs(rest) - 1, e = (w << 5) + k;
        const int i = e / lanes, l = e - i * lanes;
        int c[3], jp = -1, cp = 0;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          c[j] = pair_cell(p, 3 * i + j, l, lanes);
          if (jp < 0 && p.d[c[j]] == 1) {
            jp = j;
            cp = c[j];
          }
        }
        if (jp < 0) continue;
        pw |= 1u << k;
        const float v = 0.0f + p.sign[3 * i + jp] * p.y[cp];
        vout[e] = v;  // each element is peeled at most once
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          atomicAdd(&p.hit[c[j]], 1u);
          atomicExch(&p.hv[c[j]], p.sign[3 * i + j] * v);
        }
      }
      p.pk[w] = pw;
      if (pw) {
        p.bw[w] = b & ~pw;
        any = true;
      }
    }
    ++done;
    if (!__syncthreads_or(any)) break;

    // Scatter: subtract this round's values and degrees from the cells
    // they hash to. Warps take 32 consecutive cells at a time.
    for (int base = threadIdx.x & ~31; base < ns; base += blockDim.x) {
      const int c = base + lane;
      uint32_t h = 0;
      if (c < ns) {
        h = p.hit[c];
        if (h) p.hit[c] = 0u;
      }
      if (h == 1u) {
        p.y[c] -= 0.0f + p.hv[c];
        p.d[c] -= 1;
      }
      for (uint32_t multi = __ballot_sync(0xffffffffu, h >= 2u); multi;
           multi &= multi - 1) {
        const int owner = __ffs(multi) - 1, cc = base + owner;
        const int r = cc / lanes, m = cc - r * lanes, q1 = p.row_ptr[r + 1];
        float dy = 0.0f;
        int dd = 0;
        for (int q0 = p.row_ptr[r]; q0 < q1; q0 += 32) {
          const int q = q0 + lane;
          float term = 0.0f;
          bool on = false;
          if (q < q1) {
            const int t = p.ent[q];
            int src = m - p.rot[t];
            if (src < 0) src += lanes;
            const int e = (t / 3) * lanes + src;
            if ((p.pk[e >> 5] >> (e & 31)) & 1u) {
              on = true;
              term = p.sign[t] * vout[e];
            }
          }
          for (uint32_t bal = __ballot_sync(0xffffffffu, on); bal; bal &= bal - 1) {
            dy += __shfl_sync(0xffffffffu, term, __ffs(bal) - 1);
            ++dd;
          }
        }
        if (lane == owner) {
          p.y[cc] -= dy;
          p.d[cc] -= dd;
        }
      }
    }
    __syncthreads();
  }

  // Output: bits still set take the median-of-3 estimate, sum - max -
  // min; peeled elements keep the value their gather wrote; the rest 0.
  auto out = [&](int e, uint32_t cur, uint32_t org) -> float {
    if (cur) {
      const int i = e / lanes, l = e - i * lanes;
      float v[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        v[j] = p.sign[3 * i + j] * p.y[pair_cell(p, 3 * i + j, l, lanes)];
      return 0.0f + (v[0] + v[1] + v[2] - fmaxf(fmaxf(v[0], v[1]), v[2]) -
                     fminf(fminf(v[0], v[1]), v[2]));
    }
    return org ? vout[e] : 0.0f;
  };
  if ((n & 3) == 0 && ((reinterpret_cast<uintptr_t>(vout) & 15) |
                       (reinterpret_cast<uintptr_t>(rout) & 3)) == 0) {
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x) {
      const int e = 4 * k, w = e >> 5, sh = e & 31;
      const uint32_t cur = (p.bw[w] >> sh) & 0xfu, org = (p.org[w] >> sh) & 0xfu;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      // one copy of the median's code for the four lanes of the vector
#pragma unroll 1
      for (uint32_t rest = org; rest; rest &= rest - 1) {  // cur within org
        const int q = __ffs(rest) - 1;
        const float x = out(e + q, cur & (1u << q), 1u);
        v.x = q == 0 ? x : v.x;
        v.y = q == 1 ? x : v.y;
        v.z = q == 2 ? x : v.z;
        v.w = q == 3 ? x : v.w;
      }
      reinterpret_cast<float4*>(vout)[k] = v;
      reinterpret_cast<char4*>(rout)[k] =
          make_char4(cur & 1u, (cur >> 1) & 1u, (cur >> 2) & 1u, cur >> 3);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const uint32_t bit = 1u << (e & 31);
      const uint32_t cur = p.bw[e >> 5] & bit, org = p.org[e >> 5] & bit;
      vout[e] = out(e, cur, org);
      rout[e] = cur ? 1 : 0;
    }
  }
  return done;
}

// The most dynamic shared memory a block may opt in to on `device`, or a
// negative cudaError_t.
inline int max_smem_optin(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -(int)err;
}

inline int set_smem(const void* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // clear it; report it below
  return (int)err;
}

// Blocks of kernel `fn` at `threads` a block and `smem` bytes of dynamic
// shared memory that one SM of the current device holds at once, or a
// negative cudaError_t.
inline int occupancy(const void* fn, int threads, size_t smem) {
  int err = set_smem(fn, smem);
  if (err) return -err;
  int blocks = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return blocks;
}

}  // namespace sketch_tile
