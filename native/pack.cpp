// Native packed-supergraph batch builder.
//
// C++ twin of gcnbmp_tpu/data/packing.py (the executable spec; both are
// tested for exact agreement): first-fit-decreasing bin packing of a
// batch of pair molecules into fixed 128-atom MXU tiles, emitting either
// the COO edge list (for on-device adjacency materialization — the fast
// path: ~1 MB host->device instead of ~120 MB dense) or the dense
// (P, 4, T, T) adjacency.  The reference has no counterpart (its only
// batching is chainer_chemistry concat_mols pad-to-max, SURVEY §2.8);
// this is the input pipeline of SURVEY §7.1.
//
// The per-batch Python implementation costs ~200 ms for a 2048-pair
// batch — far above the ~7 ms device step — so the hot path lives here.
//
// C API (ctypes-friendly): see pack_pairs below.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

struct PackResult {
  int32_t tiles = 0;      // tile count actually used (<= capacity P)
  int32_t n_edges = 0;    // directed edges emitted
  int32_t n_mols = 0;
  int32_t error = 0;      // 1 = molecule larger than tile, 2 = tiles overflow
  std::vector<int32_t> atom_ids;    // (P, T)
  std::vector<int32_t> mol_id;      // (P, T)
  std::vector<float> node_mask;     // (P, T)
  std::vector<int32_t> e_tile, e_type, e_src, e_dst;  // (n_edges,)
  std::vector<int32_t> left_index, right_index;       // (B,)
  std::vector<float> adj;           // dense (P, 4, T, T) when requested
};

// First-fit-decreasing, identical ordering to the Python spec:
// np.argsort(sizes, kind="stable")[::-1] — i.e. by (size desc, index desc).
std::vector<std::vector<int32_t>> first_fit_pack(
    const std::vector<int32_t>& sizes, int tile, int* error) {
  std::vector<int32_t> order(sizes.size());
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return sizes[a] < sizes[b]; });
  std::reverse(order.begin(), order.end());
  std::vector<std::vector<int32_t>> bins;
  std::vector<int32_t> space;
  for (int32_t idx : order) {
    int32_t s = sizes[idx];
    if (s > tile) {
      *error = 1;
      return bins;
    }
    bool placed = false;
    for (size_t b = 0; b < bins.size(); ++b) {
      if (space[b] >= s) {
        bins[b].push_back(idx);
        space[b] -= s;
        placed = true;
        break;
      }
    }
    if (!placed) {
      bins.push_back({idx});
      space.push_back(tile - s);
    }
  }
  return bins;
}

}  // namespace

extern "C" {

// Pack a batch of molecule pairs from a flattened dataset cache.
//
//   indices[b]            dataset row of pair b; its molecules are cache
//                         entries 2*row (left) and 2*row + 1 (right)
//   sizes[m]              atom count of cache molecule m
//   atom_offsets[m]       int64 prefix offsets into atom_ids_flat
//   edge_offsets[m]       int64 prefix offsets into e_*_flat (directed)
//   tile                  tile width T (128)
//   num_tiles             fixed tile capacity P (0 = exactly as required)
//   want_dense            also fill the dense (P, 4, T, T) adjacency
//
// Returns an opaque handle; read via pack_out_* getters; free with
// pack_free.  pack_out_error: 0 ok, 1 molecule > tile, 2 tile overflow.
void* pack_pairs(const int32_t* indices, int32_t n_pairs,
                 const int32_t* sizes, const int64_t* atom_offsets,
                 const int32_t* atom_ids_flat, const int64_t* edge_offsets,
                 const int32_t* e_type_flat, const int32_t* e_src_flat,
                 const int32_t* e_dst_flat, int32_t tile, int32_t num_tiles,
                 int32_t want_dense, int32_t n_threads) {
  auto* r = new PackResult();
  const int32_t n_mols = 2 * n_pairs;
  r->n_mols = n_mols;

  // local (batch-ordered) molecule list: mol 2b = left of pair b, 2b+1 = right
  std::vector<int32_t> cache_idx(n_mols);
  std::vector<int32_t> local_sizes(n_mols);
  for (int32_t b = 0; b < n_pairs; ++b) {
    cache_idx[2 * b] = 2 * indices[b];
    cache_idx[2 * b + 1] = 2 * indices[b] + 1;
  }
  for (int32_t m = 0; m < n_mols; ++m) local_sizes[m] = sizes[cache_idx[m]];

  auto bins = first_fit_pack(local_sizes, tile, &r->error);
  if (r->error) return r;
  int32_t p_req = (int32_t)bins.size();
  int32_t p = num_tiles > 0 ? num_tiles : p_req;
  if (p_req > p) {
    r->error = 2;
    return r;
  }
  r->tiles = p;

  // placements sorted by (tile, offset) define the remapped mol ids so the
  // flattened mol_id array is sorted (sorted segment_sum on device)
  struct Place { int32_t mol, tile, off; };
  std::vector<Place> placements;
  placements.reserve(n_mols);
  for (int32_t b = 0; b < (int32_t)bins.size(); ++b) {
    std::sort(bins[b].begin(), bins[b].end());
    int32_t off = 0;
    for (int32_t m : bins[b]) {
      placements.push_back({m, b, off});
      off += local_sizes[m];
    }
  }
  std::sort(placements.begin(), placements.end(),
            [](const Place& a, const Place& b) {
              return a.tile != b.tile ? a.tile < b.tile : a.off < b.off;
            });

  r->atom_ids.assign((size_t)p * tile, 0);
  r->mol_id.assign((size_t)p * tile, n_mols);
  r->node_mask.assign((size_t)p * tile, 0.0f);
  std::vector<int32_t> remap(n_mols);
  // per-molecule edge output offsets (prefix sum in placement order)
  std::vector<int64_t> eo(placements.size() + 1, 0);
  for (size_t k = 0; k < placements.size(); ++k) {
    int32_t ci = cache_idx[placements[k].mol];
    eo[k + 1] = eo[k] + (edge_offsets[ci + 1] - edge_offsets[ci]);
  }
  r->n_edges = (int32_t)eo.back();
  r->e_tile.resize(r->n_edges);
  r->e_type.resize(r->n_edges);
  r->e_src.resize(r->n_edges);
  r->e_dst.resize(r->n_edges);
  if (want_dense) r->adj.assign((size_t)p * 4 * tile * tile, 0.0f);

  const size_t tt = (size_t)tile * tile;
  auto fill = [&](size_t k0, size_t k1) {
    for (size_t k = k0; k < k1; ++k) {
      const auto& pl = placements[k];
      const int32_t ci = cache_idx[pl.mol];
      const int32_t n = local_sizes[pl.mol];
      const int64_t a0 = atom_offsets[ci];
      int32_t* row = r->atom_ids.data() + (size_t)pl.tile * tile + pl.off;
      std::memcpy(row, atom_ids_flat + a0, sizeof(int32_t) * n);
      int32_t* mrow = r->mol_id.data() + (size_t)pl.tile * tile + pl.off;
      std::fill(mrow, mrow + n, (int32_t)k);
      float* nrow = r->node_mask.data() + (size_t)pl.tile * tile + pl.off;
      std::fill(nrow, nrow + n, 1.0f);
      const int64_t e0 = edge_offsets[ci];
      const int64_t ne = edge_offsets[ci + 1] - e0;
      int64_t out = eo[k];
      for (int64_t e = 0; e < ne; ++e) {
        const int32_t et = e_type_flat[e0 + e];
        const int32_t es = e_src_flat[e0 + e] + pl.off;
        const int32_t ed = e_dst_flat[e0 + e] + pl.off;
        r->e_tile[out + e] = pl.tile;
        r->e_type[out + e] = et;
        r->e_src[out + e] = es;
        r->e_dst[out + e] = ed;
        if (want_dense)
          r->adj[((size_t)pl.tile * 4 + et) * tt + (size_t)es * tile + ed] = 1.0f;
      }
    }
  };
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  nt = std::max(1, std::min<int>(nt, 16));
  if (nt <= 1 || placements.size() < 256) {
    fill(0, placements.size());
  } else {
    std::vector<std::thread> threads;
    size_t chunk = (placements.size() + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      size_t k0 = t * chunk, k1 = std::min(placements.size(), k0 + chunk);
      if (k0 >= k1) break;
      threads.emplace_back(fill, k0, k1);
    }
    for (auto& th : threads) th.join();
  }

  for (size_t k = 0; k < placements.size(); ++k)
    remap[placements[k].mol] = (int32_t)k;
  r->left_index.resize(n_pairs);
  r->right_index.resize(n_pairs);
  for (int32_t b = 0; b < n_pairs; ++b) {
    r->left_index[b] = remap[2 * b];
    r->right_index[b] = remap[2 * b + 1];
  }
  return r;
}

int32_t pack_out_error(void* h) { return ((PackResult*)h)->error; }
int32_t pack_out_tiles(void* h) { return ((PackResult*)h)->tiles; }
int32_t pack_out_n_edges(void* h) { return ((PackResult*)h)->n_edges; }
const int32_t* pack_out_atom_ids(void* h) { return ((PackResult*)h)->atom_ids.data(); }
const int32_t* pack_out_mol_id(void* h) { return ((PackResult*)h)->mol_id.data(); }
const float* pack_out_node_mask(void* h) { return ((PackResult*)h)->node_mask.data(); }
const int32_t* pack_out_e_tile(void* h) { return ((PackResult*)h)->e_tile.data(); }
const int32_t* pack_out_e_type(void* h) { return ((PackResult*)h)->e_type.data(); }
const int32_t* pack_out_e_src(void* h) { return ((PackResult*)h)->e_src.data(); }
const int32_t* pack_out_e_dst(void* h) { return ((PackResult*)h)->e_dst.data(); }
const int32_t* pack_out_left_index(void* h) { return ((PackResult*)h)->left_index.data(); }
const int32_t* pack_out_right_index(void* h) { return ((PackResult*)h)->right_index.data(); }
const float* pack_out_adj(void* h) { return ((PackResult*)h)->adj.data(); }
void pack_free(void* h) { delete (PackResult*)h; }

}  // extern "C"
