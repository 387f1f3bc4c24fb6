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

constexpr int kThreads = 512;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// rot[3i + j] = rot_j(i, blk), as src/repro/core/hashing.py:block_rotations.
__device__ __forceinline__ void block_rotations(int* rot, uint32_t blk,
                                                int group, int lanes,
                                                uint32_t salt) {
  for (int t = threadIdx.x; t < group * 3; t += blockDim.x) {
    uint32_t key = blk * 0x01000193u + (uint32_t)t + salt;
    rot[t] = (int)(mix32(key) % (uint32_t)lanes);
  }
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

// Count-Sketch encode of one block from its values xs (shared or device
// memory) into sb (rows, lanes). Every sketch cell (r, m) is owned by one
// thread, which sums its contributions in the reference's (i, j) order
// from 0.0 using the per-row list of the (i, j) pairs that hash to row r
// (row_ptr/ent, with their signs): no atomics. Returns the thread's
// max |cell|.
template <typename TS>
__device__ __forceinline__ float encode_cells(
    const float* xs, const int* rot, const int* __restrict__ row_ptr,
    const int* __restrict__ ent, const float* __restrict__ ent_sign, TS* sb,
    float s, int lanes, int rows) {
  float mx = 0.0f;
  for (int m = threadIdx.x; m < lanes; m += blockDim.x) {
    for (int r = 0; r < rows; ++r) {
      float acc = 0.0f;
      for (int q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
        const int t = ent[q];
        int src = m - rot[t];
        if (src < 0) src += lanes;
        acc += ent_sign[q] * xs[(t / 3) * lanes + src];
      }
      store_cell(sb + r * lanes + m, acc, s);
      mx = fmaxf(mx, fabsf(acc));
    }
  }
  return mx;
}

// Bytes of dynamic shared memory an encode needs: the x block when
// `resident`, then the rotations.
inline size_t encode_smem(int group, int lanes, int resident) {
  return sizeof(float) * (resident ? (size_t)group * lanes : 0) +
         sizeof(int) * 3 * (size_t)group;
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
