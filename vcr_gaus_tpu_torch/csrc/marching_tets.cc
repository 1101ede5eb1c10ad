// Isosurface extraction via marching tetrahedra over a dense SDF grid: the
// host step of the port's mesh extraction (vcr_gaus_tpu_torch/meshing/
// marching.py), the same source as the JAX package's native/marching_tets.cc
// so both packages emit the same mesh. Marching tetrahedra is table-free
// (each cube splits into 6 tets around the 0-6 diagonal; each tet has only 3
// non-trivial sign cases) and dedupes vertices via an edge hash so the
// output is a compact indexed mesh.
//
// NaN SDF marks unobserved voxels: any tet touching one is skipped.
//
// C ABI (ctypes): returns 0 on success, 1 if capacities were too small (the
// required counts are still written; caller re-calls with bigger buffers).

#include <cmath>
#include <cstdint>
#include <unordered_map>

namespace {

struct V3 { float x, y, z; };

inline int64_t edge_key(int64_t a, int64_t b) {
  if (a > b) { int64_t t = a; a = b; b = t; }
  return (a << 32) | b;
}

// 6-tetrahedra decomposition of a cube, all sharing the 0-6 diagonal.
// Corner c in 0..7 maps to offset (c&1, (c>>1)&1, (c>>2)&1).
const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

class MeshBuilder {
 public:
  MeshBuilder(float* verts, int64_t vcap, int32_t* faces, int64_t fcap)
      : verts_(verts), vcap_(vcap), faces_(faces), fcap_(fcap) {}

  int vertex(int64_t ka, int64_t kb, const V3& pa, const V3& pb,
             float sa, float sb, float iso) {
    int64_t key = edge_key(ka, kb);
    auto it = cache_.find(key);
    if (it != cache_.end()) return it->second;
    float t = (iso - sa) / (sb - sa);
    if (!(t >= 0.f)) t = 0.f;
    if (!(t <= 1.f)) t = 1.f;
    int id = static_cast<int>(nv_);
    if (nv_ < vcap_) {
      verts_[3 * nv_ + 0] = pa.x + t * (pb.x - pa.x);
      verts_[3 * nv_ + 1] = pa.y + t * (pb.y - pa.y);
      verts_[3 * nv_ + 2] = pa.z + t * (pb.z - pa.z);
    }
    ++nv_;
    cache_.emplace(key, id);
    return id;
  }

  void face(int a, int b, int c) {
    if (nf_ < fcap_) {
      faces_[3 * nf_ + 0] = a;
      faces_[3 * nf_ + 1] = b;
      faces_[3 * nf_ + 2] = c;
    }
    ++nf_;
  }

  int64_t nv() const { return nv_; }
  int64_t nf() const { return nf_; }

 private:
  float* verts_;
  int64_t vcap_;
  int32_t* faces_;
  int64_t fcap_;
  int64_t nv_ = 0, nf_ = 0;
  std::unordered_map<int64_t, int> cache_;
};

}  // namespace

extern "C" int marching_tets(
    const float* sdf, int64_t nx, int64_t ny, int64_t nz, float iso,
    const float* origin, const float* spacing,
    float* out_verts, int64_t vert_cap,
    int32_t* out_faces, int64_t face_cap,
    int64_t* n_verts, int64_t* n_faces) {
  MeshBuilder mb(out_verts, vert_cap, out_faces, face_cap);
  const int64_t syz = ny * nz;

  for (int64_t i = 0; i + 1 < nx; ++i) {
    for (int64_t j = 0; j + 1 < ny; ++j) {
      for (int64_t k = 0; k + 1 < nz; ++k) {
        float s[8];
        V3 p[8];
        int64_t gid[8];
        bool bad = false;
        for (int c = 0; c < 8; ++c) {
          int64_t ci = i + (c & 1), cj = j + ((c >> 1) & 1),
                  ck = k + ((c >> 2) & 1);
          int64_t g = ci * syz + cj * nz + ck;
          float v = sdf[g];
          if (std::isnan(v)) { bad = true; break; }
          s[c] = v;
          gid[c] = g;
          p[c] = V3{origin[0] + spacing[0] * static_cast<float>(ci),
                    origin[1] + spacing[1] * static_cast<float>(cj),
                    origin[2] + spacing[2] * static_cast<float>(ck)};
        }
        if (bad) continue;
        // quick reject: all same side
        bool any_lo = false, any_hi = false;
        for (int c = 0; c < 8; ++c) (s[c] < iso ? any_lo : any_hi) = true;
        if (!any_lo || !any_hi) continue;

        for (int t = 0; t < 6; ++t) {
          const int* T = kTets[t];
          int lo[4], hi[4];
          int nlo = 0, nhi = 0;
          for (int v = 0; v < 4; ++v) {
            if (s[T[v]] < iso) lo[nlo++] = T[v];
            else hi[nhi++] = T[v];
          }
          if (nlo == 0 || nlo == 4) continue;
          if (nlo == 1) {
            int a = lo[0];
            int v0 = mb.vertex(gid[a], gid[hi[0]], p[a], p[hi[0]], s[a],
                               s[hi[0]], iso);
            int v1 = mb.vertex(gid[a], gid[hi[1]], p[a], p[hi[1]], s[a],
                               s[hi[1]], iso);
            int v2 = mb.vertex(gid[a], gid[hi[2]], p[a], p[hi[2]], s[a],
                               s[hi[2]], iso);
            mb.face(v0, v1, v2);
          } else if (nlo == 3) {
            int a = hi[0];
            int v0 = mb.vertex(gid[a], gid[lo[0]], p[a], p[lo[0]], s[a],
                               s[lo[0]], iso);
            int v1 = mb.vertex(gid[a], gid[lo[1]], p[a], p[lo[1]], s[a],
                               s[lo[1]], iso);
            int v2 = mb.vertex(gid[a], gid[lo[2]], p[a], p[lo[2]], s[a],
                               s[lo[2]], iso);
            mb.face(v0, v2, v1);
          } else {  // 2-2: quad -> two triangles
            int a = lo[0], b = lo[1], c = hi[0], d = hi[1];
            int vac = mb.vertex(gid[a], gid[c], p[a], p[c], s[a], s[c], iso);
            int vad = mb.vertex(gid[a], gid[d], p[a], p[d], s[a], s[d], iso);
            int vbc = mb.vertex(gid[b], gid[c], p[b], p[c], s[b], s[c], iso);
            int vbd = mb.vertex(gid[b], gid[d], p[b], p[d], s[b], s[d], iso);
            mb.face(vac, vad, vbd);
            mb.face(vac, vbd, vbc);
          }
        }
      }
    }
  }
  *n_verts = mb.nv();
  *n_faces = mb.nf();
  return (mb.nv() <= vert_cap && mb.nf() <= face_cap) ? 0 : 1;
}
