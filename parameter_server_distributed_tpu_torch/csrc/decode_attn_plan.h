// The plan of K6 (decode_attn_kernel in int8_serve.cu): how a call's
// queries and cache positions fall to thread-block clusters, blocks and
// shared memory.  Pure functions of the shapes, shared by the kernel, its
// launcher and the CPU test that compiles this header with g++
// (tests/test_torch_int8_attn_plan.py), so the test checks the indices
// the card uses.
//
// A call's queries of one (row, KV head) fall into tiles of `tile`
// queries of T, each tile's rows r = jj * G + g (query j0 + jj, query
// head h * G + g).  A tile's visible positions fall into chunks of P, one
// position a thread in the score pass; chunk c goes to rank c % cluster
// of the tile's cluster, in that block's slot (and round) c / cluster.
// Every sum that crosses chunks takes them in chunk order, so a query's
// result depends on its own positions, P and THREADS alone: not on the
// cluster size, the tile, the rounds, whether the scores are held or
// streamed, the batch or max_len.
#pragma once

#if defined(__CUDACC__)
#define ATTN_HD __host__ __device__ __forceinline__
#else
#define ATTN_HD inline
#endif

namespace attn {

constexpr int THREADS = 256;        // a block
constexpr int P = THREADS;          // positions a chunk
constexpr int WARPS = THREADS / 32;
constexpr int QS = 4;   // query rows a step of the score and V passes
constexpr int CLUSTER = 8;          // most blocks a cluster (portable)
constexpr int SMEM_MAX = 232448;    // a block's shared memory on sm_90
constexpr int SMEM_TWO = 113 * 1024;   // two blocks an SM

ATTN_HD int round16(int n) { return (n + 15) / 16 * 16; }

// positions 0..limit of a query, clipped to the cache (none below 0)
ATTN_HD int visible(long long limit, int max_len) {
  return limit < 0 ? 0
         : limit + 1 < max_len ? static_cast<int>(limit + 1) : max_len;
}

ATTN_HD int chunks(int nvis) { return (nvis + P - 1) / P; }

// the rows of a block's layout: the tile's query rows, rounded up to
// whole steps of 8 (a step's rows past the tile are computed, never
// stored: QS rows in the f32 passes, an 8-row n tile of the tensor cores'
// score pass)
ATTN_HD int layout_rows(int G, int tile) { return (G * tile + 7) / 8 * 8; }

// the bf16 weights of the tensor cores' V pass: [hold][wb_rows][WBS],
// the rows rounded up to a 16-row m tile
constexpr int WBS = P + 8;   // elements a row (rows 16 bytes apart in banks)
ATTN_HD int wb_rows(int rows) { return (rows + 15) / 16 * 16; }

// the chunk a block of rank `rank` holds in slot `slot`: in round `slot`
// the cluster's blocks take chunks slot * cluster .. + cluster - 1
ATTN_HD int chunk_of(int rank, int slot, int cluster) {
  return rank + slot * cluster;
}

// slots a block of rank `rank` fills when the tile has `nch` chunks; the
// tile's rounds are those of rank 0
ATTN_HD int slots_of(int rank, int nch, int cluster) {
  return rank < nch ? (nch - rank + cluster - 1) / cluster : 0;
}

// a chunk's K and V rows in bytes, padded by 16 (neighbouring rows' 16-
// byte reads, and the tensor cores' reads down a column, fall on distinct
// banks)
ATTN_HD int kstride(int d) { return round16(d) + 16; }
ATTN_HD int vstride(int d) { return round16(d) + 16; }

// the elements of a tile's n outputs that each block of a cluster of c
// adds up and stores
ATTN_HD int share(int n, int c) { return (n + c - 1) / c; }

// copies of the V inbox: two where a tile takes more than one round (a
// round's stores land while the last round's are still being added)
ATTN_HD int obufs(int rounds) { return rounds > 1 ? 2 : 1; }

// Shared memory of a block, byte offsets: the K rows at 0 (the V pass's
// group partials reuse them), the V rows, the tile's queries (f32), the
// scores [hold][rows][P], the K scales [P] and V scales [hold][P] of the
// chunks held, each query row's visible positions [rows] (int), its
// block max and its sum so far [rows], the tensor cores' bf16 weights,
// and the inboxes the cluster's blocks store into: every block's max
// [cluster][rows], a round's chunk sums [2][cluster][rows] and V partials
// of the outputs this block ends [obufs][cluster][share(rows * d,
// cluster)], and those outputs' sums so far where there are rounds
// after the first.  Nothing grows with the rounds past `hold`.
struct Layout {
  int vbuf, qs, sc, ks, vs, nv, mx, tot, wb, mxin, psin, oin, oacc, bytes;
};

ATTN_HD Layout layout(int rows, int d, int hold, int cluster, int rounds) {
  Layout l;
  const int kbytes = P * kstride(d), vred = THREADS * QS * 16;
  const int per = share(rows * d, cluster);
  int at = kbytes > vred ? kbytes : vred;
  l.vbuf = at;
  at += P * vstride(d);
  l.qs = at;
  at += round16(rows * d * 4);
  l.sc = at;
  at += hold * rows * P * 4;
  l.ks = at;
  at += P * 4;
  l.vs = at;
  at += hold * P * 4;
  l.nv = at;
  at += round16(rows * 4);
  l.mx = at;
  at += round16(rows * 4);
  l.tot = at;
  at += round16(rows * 4);
  l.wb = at;
  at += hold * wb_rows(rows) * WBS * 2;
  l.mxin = at;
  at += round16(cluster * rows * 4);
  l.psin = at;
  at += round16(2 * cluster * rows * 4);
  l.oin = at;
  at += round16(obufs(rounds) * cluster * per * 4);
  l.oacc = at;
  at += rounds > 1 ? round16(per * 4) : 0;
  l.bytes = at;
  return l;
}

// rounds: chunks of a block (a tile takes them in rounds, one chunk a
// block a round); hold: the slots of scores kept.  A tile of at most
// `hold` rounds scores each chunk once; a longer one streams its chunks
// through one slot and scores each again in the sum pass and the V pass
// (the same bits: the scores are a pure function of the chunk).
struct Plan {
  int cluster, rounds, hold, tile, tiles, smem;   // smem 0: nothing fits
};

// the most queries of T (0: none) whose block fits `budget` bytes
inline int fit(int T, int G, int d, int hold, int cluster, int rounds,
               int budget) {
  int lo = 0, hi = T;   // the most queries that fit: in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (layout(layout_rows(G, mid), d, hold, cluster, rounds).bytes <=
        budget)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The plan of a call: T queries a row, G query heads a KV head, head dim
// d, and `vis`, the most positions a query of the call can see (max_len
// for ragged rows).  The cluster takes every chunk at once up to CLUSTER
// blocks (16 blocks of 128 positions were no faster at a decode round and
// half as fast at an extension).  Held (every round's scores kept) and
// streamed (one slot) each take the most queries a tile whose block fits
// two to an SM, else one; of the two the plan takes the one that reads
// the K rows fewer times (a tile reads them once held, three times
// streamed), held on a tie.
inline Plan plan(int T, int G, int d, int vis) {
  Plan best{};
  const int n = chunks(vis) > 0 ? chunks(vis) : 1;
  const int cluster = n < CLUSTER ? n : CLUSTER;
  const int rounds = (n + cluster - 1) / cluster;
  const int holds[2] = {rounds, 1};
  const int budgets[2] = {SMEM_TWO, SMEM_MAX};
  for (const int hold : holds) {
    for (const int budget : budgets) {
      const int tile = fit(T, G, d, hold, cluster, rounds, budget);
      if (tile == 0) continue;
      const int tiles = (T + tile - 1) / tile;
      const int reads = tiles * (hold < rounds ? 3 : 1);
      if (best.smem == 0 ||
          reads < best.tiles * (best.hold < rounds ? 3 : 1))
        best = Plan{cluster, rounds, hold, tile, tiles,
                    layout(layout_rows(G, tile), d, hold, cluster, rounds)
                        .bytes};
      break;
    }
    if (rounds == 1) break;
  }
  return best;
}

}  // namespace attn
