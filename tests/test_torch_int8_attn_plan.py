"""The plan of the int8 decode attention kernel (K6 in
``csrc/int8_serve.cu``) on the CPU: ``csrc/decode_attn_plan.h``, the
pure functions the kernel and its launcher take their tiles, chunks,
rounds and shared memory from, built with g++ beside a small C stub.
For first limits from 0 to ``max_len + 3`` (every one within a chunk of
either end, a sample between; ragged and contiguous calls, T up to 256,
caches up to 57,344 positions, the registry's GQA ratios and head dims):
every query lies in one tile, every visible position of a query in one
chunk that exactly one block of its cluster holds, in the round the
layout's inboxes are sized for, every output element falls to a block,
and the shared memory stays within the card's 227 KB, which caches up
to 2^20 positions also keep."""

import ctypes
import os
import shutil
import subprocess

import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "parameter_server_distributed_tpu_torch", "csrc")

STUB = r"""
#include <algorithm>
#include <vector>

#include "decode_attn_plan.h"

extern "C" int attn_plan(int T, int G, int d, int vis, int* out) {
  const attn::Plan p = attn::plan(T, G, d, vis);
  const int fields[6] = {p.cluster, p.rounds, p.hold, p.tile, p.tiles,
                         p.smem};
  std::copy(fields, fields + 6, out);
  return attn::SMEM_MAX;
}

// The faults of the plans of T queries a row against a cache of max_len,
// one plan for each first limit from 0 to max_len + 3 (past a chunk from
// either end, every `stride`-th one).
extern "C" long long attn_plan_faults(int T, int G, int d, int max_len,
                                      int ragged, int stride) {
  long long faults = 0;
  const long long edge = attn::P + 3;
  for (long long first = 0; first <= max_len + 3; ++first) {
    if (first > edge && first < max_len - edge && first % stride) continue;
    const int vis =
        ragged ? max_len : attn::visible(first + T - 1, max_len);
    const attn::Plan p = attn::plan(T, G, d, vis);
    if (p.tile < 1 || p.smem <= 0 || p.smem > attn::SMEM_MAX ||
        p.cluster < 1 || p.cluster > attn::CLUSTER || p.hold < 1 ||
        p.hold > p.rounds) {
      ++faults;
      continue;
    }
    if (static_cast<long long>(p.tiles) * p.tile < T ||
        static_cast<long long>(p.tiles - 1) * p.tile >= T)
      ++faults;   // a query in no tile, or a tile of none
    if (attn::layout(attn::layout_rows(G, p.tile), d, p.hold, p.cluster,
                     p.rounds).bytes != p.smem)
      ++faults;
    for (int tile = 0; tile < p.tiles; ++tile) {
      const int j0 = tile * p.tile;
      const int nq = G * std::min(p.tile, T - j0);
      const int nv_max = attn::visible(first + j0 + (nq - 1) / G, max_len);
      const int nch = attn::chunks(nv_max);
      if (!ragged && nv_max > vis) ++faults;   // read past the plan
      // every rank takes part in the tile's rounds, which the layout's
      // inboxes are sized for
      if (attn::slots_of(0, nch, p.cluster) > p.rounds) ++faults;
      std::vector<int> held(nch, 0);
      for (int rank = 0; rank < p.cluster; ++rank) {
        const int mine = attn::slots_of(rank, nch, p.cluster);
        if (mine > attn::slots_of(0, nch, p.cluster)) ++faults;
        for (int i = 0; i < mine; ++i) {
          const int c = attn::chunk_of(rank, i, p.cluster);
          if (c < 0 || c >= nch || c / p.cluster != i)
            ++faults;   // in round i the cluster takes chunks i * cluster..
          else
            ++held[c];
        }
      }
      for (int c = 0; c < nch; ++c) faults += held[c] != 1;
      // a query's positions [0, nv) lie in chunks 0..chunks(nv) - 1, cut
      // at the tile's last visible position
      for (int r = 0; r < nq; r += std::max(1, G)) {
        const int nv = attn::visible(first + j0 + r / G, max_len);
        int covered = 0;
        for (int c = 0; c < attn::chunks(nv); ++c)
          covered += std::min({(c + 1) * attn::P, nv, nv_max}) - c * attn::P;
        faults += nv > nv_max || covered != nv;
      }
      const int total = nq * d, per = attn::share(total, p.cluster);
      faults += static_cast<long long>(per) * p.cluster < total ||
                per > attn::share(attn::layout_rows(G, p.tile) * d, p.cluster);
    }
  }
  return faults;
}
"""


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs g++ to build the plan's header")
    tmp = tmp_path_factory.mktemp("attn_plan")
    src, out = tmp / "stub.cpp", tmp / "libattn_plan.so"
    src.write_text(STUB)
    subprocess.run([compiler, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(out), str(src)], check=True,
                   timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.attn_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.attn_plan_faults.argtypes = [ctypes.c_int] * 6
    lib.attn_plan_faults.restype = ctypes.c_longlong
    return lib


def _plan(lib, t, g, d, vis):
    out = (ctypes.c_int * 6)()
    smem_max = lib.attn_plan(t, g, d, vis, out)
    return dict(zip(("cluster", "rounds", "hold", "tile", "tiles", "smem"),
                    out)), smem_max


@pytest.mark.parametrize("g,d", [(4, 64), (1, 64), (1, 32), (1, 128),
                                 (8, 256), (2, 12), (8, 128)])
@pytest.mark.parametrize("t", [1, 5, 256])
@pytest.mark.parametrize("max_len", [40, 700, 2048])
def test_every_visible_position_falls_to_one_block(plan_lib, g, d, t,
                                                   max_len):
    for ragged in (1, 0):
        assert plan_lib.attn_plan_faults(t, g, d, max_len, ragged, 1) == 0, \
            ragged


@pytest.mark.parametrize("g,d", [(4, 64), (1, 64), (1, 128), (8, 256),
                                 (2, 12)])
def test_long_caches_put_every_position_in_one_block(plan_lib, g, d):
    """An extension of 256 queries over a 16,384-position cache and a
    decode round over 57,344 positions, held and streamed rounds: every
    first limit within a chunk of either end, every 128th between."""
    for max_len, t in ((16384, 256), (57344, 1)):
        for ragged in (1, 0):
            assert plan_lib.attn_plan_faults(t, g, d, max_len, ragged,
                                             128) == 0, (max_len, ragged)


@pytest.mark.parametrize("g,d", [(4, 64), (1, 64), (1, 128), (8, 128),
                                 (8, 256)])
def test_long_caches_have_a_plan(plan_lib, g, d):
    """Shared memory does not grow with the cache: past the rounds a block
    can hold, a tile streams its chunks through one slot, so every cache
    up to 2^20 positions has a plan, for one query and for 256."""
    for t in (1, 256):
        for vis in (8192, 16384, 20000, 57344, 131072, 1 << 20):
            plan, smem_max = _plan(plan_lib, t, g, d, vis)
            assert 0 < plan["smem"] <= smem_max, (t, vis, plan)
            assert plan["cluster"] == 8 and plan["rounds"] == -(-vis // 2048)
            assert 1 <= plan["hold"] <= plan["rounds"]
            assert plan["tiles"] * plan["tile"] >= t


def test_the_serving_shapes_plans(plan_lib):
    """A decode round of llama_350m (G 4, D 64, 2048 positions): 8 blocks
    of one chunk each, one query a tile; the extension (256 queries over
    1280 positions) takes 5 blocks and tiles that fit two to an SM; a
    decode round over 57,344 positions streams 28 rounds through one
    slot."""
    decode, smem_max = _plan(plan_lib, 1, 4, 64, 2048)
    assert decode == dict(cluster=8, rounds=1, hold=1, tile=1, tiles=1,
                          smem=decode["smem"])
    assert decode["smem"] <= smem_max // 2
    extend, _ = _plan(plan_lib, 256, 4, 64, 1280)
    assert extend["cluster"] == 5 and extend["rounds"] == 1
    assert extend["tiles"] * extend["tile"] >= 256
    assert 2 * (extend["smem"] + 1024) <= smem_max
    long, _ = _plan(plan_lib, 1, 4, 64, 57344)
    assert (long["rounds"], long["hold"], long["tiles"]) == (28, 1, 1)


@pytest.mark.parametrize("g,max_len", [(4, 2048), (2, 512), (1, 300)])
@pytest.mark.parametrize("t", [2, 3, 4, 5])
def test_verify_blocks_plan(plan_lib, g, max_len, t):
    """A speculative verify block (T = k + 1 queries a row at k 1..4, D
    64: llama_350m's G 4 at 2048 positions, a 2-layer model's G 2 at 512,
    G 1): every visible position of every first limit falls to one block
    of its cluster, and the T queries share one tile, so each query's
    chunk sums run as a single query's do."""
    assert plan_lib.attn_plan_faults(t, g, 64, max_len, 1, 1) == 0
    plan, smem_max = _plan(plan_lib, t, g, 64, max_len)
    assert plan["tiles"] == 1 and plan["tile"] >= t
    assert plan["rounds"] == 1 and 0 < plan["smem"] <= smem_max
