// Native CPU comparison renderer (the benchmark baseline producer).
//
// BASELINE.md's wall-clock target compares the TPU renderer against "a
// native Rust runner on a 32-core CPU" — which the reference does not
// ship (it is GPU-only), so the benchmark harness must produce the
// comparison point itself (BASELINE.md note). This is that runner, with
// two modes:
//
//   spheres (default): the reference's architecture — brute-force linear
//     closest-hit scan (no BVH, matching shader.wgsl:314-329) over the
//     RTiOW final scene; `--bvh` upgrades it to a binned-SAH BVH so the
//     CPU baseline is a *strong* one, not a strawman.
//   --mesh FILE: triangle meshes (BASELINE config 5). Loads a flat binary
//     scene dump (written by myraytracer_tpu/native/meshdump.py), builds
//     the same binned-SAH skip-link BVH the TPU-side host preprocessing
//     uses (src/bvh.cpp, linked in), and path-traces with Möller-Trumbore
//     intersection — the honest CPU-with-BVH comparison point the mesh
//     throughput numbers are judged against.
//
// Lambertian/metal/dielectric/emissive materials, RTiOW semantics,
// multithreaded with std::thread. Reports Mrays/s (traced segments /
// wall-clock; one segment per bounce-loop iteration, the TPU kernel's
// counting convention).
//
// This is an independent implementation (fresh code, RTiOW semantics),
// not a port of the reference's Rust/WGSL.
//
// Since round 4 this file is ALSO the first-class `--backend cpu` render
// path: compiled into libmrt_native.so (with -DMRT_CPU_LIB, which drops
// main()) it exposes an extern "C" frame API — load a scene dump once,
// then render frames into a caller buffer with a per-frame seed and an
// optional packed runtime camera (the session's [19]-f32 `scene.cam`
// operand, render/camera.py:pack_camera layout). Frame RNG is seeded
// per ROW (splitmix64(seed, row)), so images are deterministic and
// independent of the thread count/schedule — the property the Python
// session's checkpoint provenance relies on.
//
// Build: make -C native cpu  → native/mrt_cpu_bench
// Run:   ./native/mrt_cpu_bench [width height spp depth threads] [--bvh]
//        ./native/mrt_cpu_bench --mesh scene.bin [width height spp depth threads]

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

// Binned-SAH flat skip-link BVH builder (src/bvh.cpp, linked in).
extern "C" int mrt_build_bvh(const float* prim_min, const float* prim_max,
                             int n_prims, int max_leaf, float* out_nodes_min,
                             float* out_nodes_max, int* out_first,
                             int* out_count, int* out_skip, int* out_order);

namespace {

struct Vec {
  float x = 0, y = 0, z = 0;
  Vec operator+(const Vec& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec operator-(const Vec& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec operator*(float s) const { return {x * s, y * s, z * s}; }
  Vec operator*(const Vec& o) const { return {x * o.x, y * o.y, z * o.z}; }
};
float dot(const Vec& a, const Vec& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
Vec cross(const Vec& a, const Vec& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
Vec norm(const Vec& a) { return a * (1.0f / std::sqrt(dot(a, a))); }

enum MatTy { LAMB = 1, METAL = 2, DIEL = 3, LIGHT = 4 };
enum TexTy { TEX_SOLID = 0, TEX_CHECKER = 1, TEX_MARBLE = 2 };

struct Material {
  int ty = LAMB;
  Vec albedo{1, 1, 1};
  float fuzz = 0, ior = 1.5f;
  Vec emit{0, 0, 0};
  // Texture extension (MRTMIX01 rows): albedo doubles as the checker
  // EVEN / marble base color, albedo2 is the checker ODD color.
  int tex_ty = TEX_SOLID;
  Vec albedo2{0, 0, 0};
  float tex_scale = 0;
};

// -- Procedural textures (checker / marble) ----------------------------------
//
// Same formulas as the TPU path (myraytracer_tpu/core/noise.py +
// render/textures.py): tableless lowbias32 lattice hash noise, Hermite
// interpolation, 7-octave turbulence, exact triangle-wave band — so the
// CPU backend's texture values agree with the jnp/pallas renders up to
// scalar-vs-vector float rounding (statistical parity, like the rest of
// this backend's contract).

uint32_t lowbias32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

float noise_corner(int32_t ix, int32_t iy, int32_t iz) {
  uint32_t h = uint32_t(ix) * 0x8DA6B343u ^ uint32_t(iy) * 0xD8163841u ^
               uint32_t(iz) * 0xCB1AB31Fu;
  return float(int32_t(lowbias32(h) >> 8)) * (1.0f / 16777216.0f);
}

float value_noise(const Vec& p) {
  float fx = std::floor(p.x), fy = std::floor(p.y), fz = std::floor(p.z);
  int32_t ix = int32_t(fx), iy = int32_t(fy), iz = int32_t(fz);
  float tx = p.x - fx, ty = p.y - fy, tz = p.z - fz;
  float ux = tx * tx * (3 - 2 * tx), uy = ty * ty * (3 - 2 * ty),
        uz = tz * tz * (3 - 2 * tz);
  float c000 = noise_corner(ix, iy, iz), c100 = noise_corner(ix + 1, iy, iz);
  float c010 = noise_corner(ix, iy + 1, iz), c110 = noise_corner(ix + 1, iy + 1, iz);
  float c001 = noise_corner(ix, iy, iz + 1), c101 = noise_corner(ix + 1, iy, iz + 1);
  float c011 = noise_corner(ix, iy + 1, iz + 1), c111 = noise_corner(ix + 1, iy + 1, iz + 1);
  float x00 = c000 + ux * (c100 - c000), x10 = c010 + ux * (c110 - c010);
  float x01 = c001 + ux * (c101 - c001), x11 = c011 + ux * (c111 - c011);
  float y0 = x00 + uy * (x10 - x00), y1 = x01 + uy * (x11 - x01);
  return y0 + uz * (y1 - y0);
}

float turbulence(const Vec& p) {
  float acc = 0, weight = 0.5f, freq = 1.0f;
  for (int k = 0; k < 7; ++k) {
    acc += (value_noise(p * freq) * 2.0f - 1.0f) * weight;
    weight *= 0.5f;
    freq *= 2.0f;
  }
  return std::fabs(acc);
}

float triangle_wave(float x) {
  float u = x * 0.25f;
  u -= std::floor(u);
  return std::fabs(u * 4.0f - 2.0f) - 1.0f;
}

Vec tex_albedo(const Material& m, const Vec& p) {
  if (m.tex_ty == TEX_CHECKER) {
    int32_t sx = int32_t(std::floor(p.x * m.tex_scale));
    int32_t sy = int32_t(std::floor(p.y * m.tex_scale));
    int32_t sz = int32_t(std::floor(p.z * m.tex_scale));
    return (((sx + sy + sz) & 1) == 0) ? m.albedo : m.albedo2;
  }
  if (m.tex_ty == TEX_MARBLE) {
    float band = triangle_wave(m.tex_scale * p.z + 10.0f * turbulence(p));
    return m.albedo * (0.5f * (1.0f + band));
  }
  return m.albedo;
}

struct Sphere {
  Vec c;
  float r;
  int ty;
  Vec albedo;
  float fuzz = 0, ior = 1.5f;
  Vec emit{0, 0, 0};
};

// splitmix64 finalizer: decorrelates (seed, row) into an mt19937 seed so
// per-row streams are independent and thread-schedule invariant.
uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Rng {
  std::mt19937 gen;
  std::uniform_real_distribution<float> uni{0.0f, 1.0f};
  explicit Rng(uint64_t seed) : gen(seed) {}
  float f() { return uni(gen); }
  Vec unit_sphere() {
    float z = 1 - 2 * f();
    float r = std::sqrt(std::max(0.0f, 1 - z * z));
    float p = 6.2831853f * f();
    return {r * std::cos(p), r * std::sin(p), z};
  }
  Vec unit_ball() { return unit_sphere() * std::cbrt(f()); }
  void unit_disk(float& dx, float& dy) {
    float r = std::sqrt(f());
    float p = 6.2831853f * f();
    dx = r * std::cos(p);
    dy = r * std::sin(p);
  }
};

[[maybe_unused]] std::vector<Sphere> final_scene() {
  // RTiOW final scene, deterministic.
  std::mt19937 gen(0);
  std::uniform_real_distribution<float> uni(0.0f, 1.0f);
  std::vector<Sphere> s;
  s.push_back({{0, -1000, 0}, 1000, LAMB, {0.5, 0.5, 0.5}});
  for (int a = -11; a < 11; ++a)
    for (int b = -11; b < 11; ++b) {
      float choose = uni(gen);
      Vec c{a + 0.9f * uni(gen), 0.2f, b + 0.9f * uni(gen)};
      Vec d = c - Vec{4, 0.2f, 0};
      if (std::sqrt(dot(d, d)) <= 0.9f) continue;
      if (choose < 0.8f)
        s.push_back({c, 0.2f, LAMB,
                     {uni(gen) * uni(gen), uni(gen) * uni(gen), uni(gen) * uni(gen)}});
      else if (choose < 0.95f)
        s.push_back({c, 0.2f, METAL,
                     {0.5f + 0.5f * uni(gen), 0.5f + 0.5f * uni(gen),
                      0.5f + 0.5f * uni(gen)},
                     0.5f * uni(gen)});
      else
        s.push_back({c, 0.2f, DIEL, {1, 1, 1}});
    }
  s.push_back({{0, 1, 0}, 1, DIEL, {1, 1, 1}});
  s.push_back({{-4, 1, 0}, 1, LAMB, {0.4f, 0.2f, 0.1f}});
  s.push_back({{4, 1, 0}, 1, METAL, {0.7f, 0.6f, 0.5f}, 0});
  return s;
}

struct Hit {
  float t;
  int idx;
};

// Brute-force linear scan, as in the reference (shader.wgsl:314-329).
bool world_hit(const std::vector<Sphere>& w, const Vec& o, const Vec& d,
               float tmin, float tmax, Hit* out) {
  float best = tmax;
  int bi = -1;
  for (size_t i = 0; i < w.size(); ++i) {
    Vec oc = o - w[i].c;
    float b = dot(oc, d);
    float c = dot(oc, oc) - w[i].r * w[i].r;
    float disc = b * b - c;
    if (disc < 0) continue;
    float sq = std::sqrt(disc);
    float t = -b - sq;
    if (t < tmin || t >= best) t = -b + sq;
    if (t < tmin || t >= best) continue;
    best = t;
    bi = static_cast<int>(i);
  }
  if (bi < 0) return false;
  out->t = best;
  out->idx = bi;
  return true;
}

// -- Flat skip-link BVH (built by mrt_build_bvh, bvh.cpp) --------------------

struct FlatBVH {
  std::vector<float> nmin, nmax;  // [m*3]
  std::vector<int> first, count, skip;
  int m = 0;
};

FlatBVH build_bvh(const std::vector<float>& pmin, const std::vector<float>& pmax,
                  int n, int max_leaf, std::vector<int>* order) {
  FlatBVH b;
  int cap = 2 * n;
  b.nmin.resize(3 * cap);
  b.nmax.resize(3 * cap);
  b.first.resize(cap);
  b.count.resize(cap);
  b.skip.resize(cap);
  order->resize(n);
  b.m = mrt_build_bvh(pmin.data(), pmax.data(), n, max_leaf, b.nmin.data(),
                      b.nmax.data(), b.first.data(), b.count.data(),
                      b.skip.data(), order->data());
  if (b.m < 0) {
    std::fprintf(stderr, "BVH build failed\n");
    std::exit(2);
  }
  b.nmin.resize(3 * b.m);
  b.nmax.resize(3 * b.m);
  b.first.resize(b.m);
  b.count.resize(b.m);
  b.skip.resize(b.m);
  return b;
}

inline bool aabb_hit(const float* mn, const float* mx, const Vec& o,
                     const Vec& invd, float tmin, float tmax) {
  // Slab test; min/max ordering handles negative direction components.
  float t0 = (mn[0] - o.x) * invd.x, t1 = (mx[0] - o.x) * invd.x;
  float lo = std::min(t0, t1), hi = std::max(t0, t1);
  t0 = (mn[1] - o.y) * invd.y, t1 = (mx[1] - o.y) * invd.y;
  lo = std::max(lo, std::min(t0, t1));
  hi = std::min(hi, std::max(t0, t1));
  t0 = (mn[2] - o.z) * invd.z, t1 = (mx[2] - o.z) * invd.z;
  lo = std::max(lo, std::min(t0, t1));
  hi = std::min(hi, std::max(t0, t1));
  return std::max(lo, tmin) <= std::min(hi, tmax);
}

// -- Triangle mesh scene (BASELINE config 5) ---------------------------------

struct Tri {
  Vec v0, e1, e2;
  int mat;
};

struct MeshScene {
  std::vector<Tri> tris;  // reordered to BVH leaf order
  std::vector<Material> mats;
  FlatBVH bvh;
  // Camera (thin-lens, RTiOW ch. 12-13 semantics).
  Vec lookfrom, lookat, vup;
  float vfov_deg = 45, aperture = 0, focus = 1;
  bool has_ambient = false;
  Vec ambient{0, 0, 0};
};

bool load_mesh_scene(const char* path, MeshScene* s) {
  // Format written by myraytracer_tpu/native/meshdump.py ("MRTMESH1").
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "MRTMESH1", 8)) {
    std::fclose(f);
    return false;
  }
  int32_t n_mats = 0, n_tris = 0, has_amb = 0;
  float cam[12], amb[3];
  bool ok = std::fread(&n_mats, 4, 1, f) == 1 && std::fread(&n_tris, 4, 1, f) == 1 &&
            std::fread(cam, 4, 12, f) == 12 && std::fread(&has_amb, 4, 1, f) == 1 &&
            std::fread(amb, 4, 3, f) == 3 && n_mats > 0 && n_tris > 0;
  if (!ok) {
    std::fclose(f);
    return false;
  }
  s->lookfrom = {cam[0], cam[1], cam[2]};
  s->lookat = {cam[3], cam[4], cam[5]};
  s->vup = {cam[6], cam[7], cam[8]};
  s->vfov_deg = cam[9];
  s->aperture = cam[10];
  s->focus = cam[11];
  s->has_ambient = has_amb != 0;
  s->ambient = {amb[0], amb[1], amb[2]};

  s->mats.resize(n_mats);
  for (auto& m : s->mats) {
    int32_t ty;
    float v[8];
    if (std::fread(&ty, 4, 1, f) != 1 || std::fread(v, 4, 8, f) != 8) {
      std::fclose(f);
      return false;
    }
    m.ty = ty;
    m.albedo = {v[0], v[1], v[2]};
    m.fuzz = v[3];
    m.ior = v[4];
    m.emit = {v[5], v[6], v[7]};
  }

  std::vector<Tri> raw(n_tris);
  std::vector<float> pmin(3 * n_tris), pmax(3 * n_tris);
  for (int i = 0; i < n_tris; ++i) {
    float v[9];
    int32_t mat;
    if (std::fread(v, 4, 9, f) != 9 || std::fread(&mat, 4, 1, f) != 1) {
      std::fclose(f);
      return false;
    }
    Vec v0{v[0], v[1], v[2]}, v1{v[3], v[4], v[5]}, v2{v[6], v[7], v[8]};
    raw[i] = {v0, v1 - v0, v2 - v0, mat};
    for (int k = 0; k < 3; ++k) {
      float a = (&v0.x)[k], b = (&v1.x)[k], c = (&v2.x)[k];
      pmin[3 * i + k] = std::min(a, std::min(b, c));
      pmax[3 * i + k] = std::max(a, std::max(b, c));
    }
  }
  std::fclose(f);

  std::vector<int> order;
  s->bvh = build_bvh(pmin, pmax, n_tris, /*max_leaf=*/4, &order);
  // Reorder triangles to BVH leaf order: node [first, first+count) then
  // indexes s->tris directly (cache-friendly leaves).
  s->tris.resize(n_tris);
  for (int j = 0; j < n_tris; ++j) s->tris[j] = raw[order[j]];
  return true;
}

inline bool tri_hit(const Tri& tr, const Vec& o, const Vec& d, float tmin,
                    float tmax, float* t_out) {
  // Möller-Trumbore; no backface culling (meshes can be seen from inside,
  // and dielectric meshes need exit hits).
  Vec pvec = cross(d, tr.e2);
  float det = dot(tr.e1, pvec);
  if (std::fabs(det) < 1e-9f) return false;
  float inv = 1.0f / det;
  Vec tvec = o - tr.v0;
  float u = dot(tvec, pvec) * inv;
  if (u < 0 || u > 1) return false;
  Vec qvec = cross(tvec, tr.e1);
  float v = dot(d, qvec) * inv;
  if (v < 0 || u + v > 1) return false;
  float t = dot(tr.e2, qvec) * inv;
  if (t < tmin || t >= tmax) return false;
  *t_out = t;
  return true;
}

bool mesh_hit(const MeshScene& s, const Vec& o, const Vec& d, float tmin,
              float tmax, Hit* out) {
  Vec invd{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float best = tmax;
  int bi = -1;
  int i = 0;
  const int m = s.bvh.m;
  while (i < m) {
    if (aabb_hit(&s.bvh.nmin[3 * i], &s.bvh.nmax[3 * i], o, invd, tmin, best)) {
      int cnt = s.bvh.count[i];
      if (cnt > 0) {
        int first = s.bvh.first[i];
        for (int j = first; j < first + cnt; ++j) {
          float t;
          if (tri_hit(s.tris[j], o, d, tmin, best, &t)) {
            best = t;
            bi = j;
          }
        }
        i = s.bvh.skip[i];  // leaf done: continue at the escape link
      } else {
        ++i;  // interior hit: descend depth-first
      }
    } else {
      i = s.bvh.skip[i];
    }
  }
  if (bi < 0) return false;
  out->t = best;
  out->idx = bi;
  return true;
}

// Sphere closest-hit through the same flat BVH (`--bvh` upgrade of the
// brute-force scan — the strong CPU baseline for sphere scenes).
struct SphereBVH {
  std::vector<Sphere> spheres;  // reordered to leaf order
  FlatBVH bvh;
};

SphereBVH build_sphere_bvh(const std::vector<Sphere>& w) {
  int n = static_cast<int>(w.size());
  std::vector<float> pmin(3 * n), pmax(3 * n);
  for (int i = 0; i < n; ++i) {
    const Vec& c = w[i].c;
    float r = std::fabs(w[i].r);  // signed radius = inward normals
    pmin[3 * i] = c.x - r, pmin[3 * i + 1] = c.y - r, pmin[3 * i + 2] = c.z - r;
    pmax[3 * i] = c.x + r, pmax[3 * i + 1] = c.y + r, pmax[3 * i + 2] = c.z + r;
  }
  SphereBVH sb;
  std::vector<int> order;
  sb.bvh = build_bvh(pmin, pmax, n, /*max_leaf=*/2, &order);
  sb.spheres.resize(n);
  for (int j = 0; j < n; ++j) sb.spheres[j] = w[order[j]];
  return sb;
}

bool sphere_bvh_hit(const SphereBVH& s, const Vec& o, const Vec& d, float tmin,
                    float tmax, Hit* out) {
  Vec invd{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float best = tmax;
  int bi = -1;
  int i = 0;
  const int m = s.bvh.m;
  while (i < m) {
    if (aabb_hit(&s.bvh.nmin[3 * i], &s.bvh.nmax[3 * i], o, invd, tmin, best)) {
      int cnt = s.bvh.count[i];
      if (cnt > 0) {
        int first = s.bvh.first[i];
        for (int j = first; j < first + cnt; ++j) {
          const Sphere& sp = s.spheres[j];
          Vec oc = o - sp.c;
          float b = dot(oc, d);
          float c = dot(oc, oc) - sp.r * sp.r;
          float disc = b * b - c;
          if (disc < 0) continue;
          float sq = std::sqrt(disc);
          float t = -b - sq;
          if (t < tmin || t >= best) t = -b + sq;
          if (t < tmin || t >= best) continue;
          best = t;
          bi = j;
        }
        i = s.bvh.skip[i];
      } else {
        ++i;
      }
    } else {
      i = s.bvh.skip[i];
    }
  }
  if (bi < 0) return false;
  out->t = best;
  out->idx = bi;
  return true;
}

// Sphere-scene dump loader ("MRTSPH01" — meshdump.dump_spheres): the
// sphere-scaling baseline surface (spheres:N scenes), identical scene
// bytes on both sides like the mesh mode.
struct SphereScene {
  std::vector<Sphere> spheres;
  Vec lookfrom, lookat, vup;
  float vfov_deg = 20, aperture = 0, focus = 10;
  bool has_ambient = false;
  Vec ambient{0, 0, 0};
};

bool load_sphere_scene(const char* path, SphereScene* s) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "MRTSPH01", 8)) {
    std::fclose(f);
    return false;
  }
  int32_t n = 0, has_amb = 0;
  float cam[12], amb[3];
  bool ok = std::fread(&n, 4, 1, f) == 1 && std::fread(cam, 4, 12, f) == 12 &&
            std::fread(&has_amb, 4, 1, f) == 1 &&
            std::fread(amb, 4, 3, f) == 3 && n > 0;
  if (!ok) {
    std::fclose(f);
    return false;
  }
  s->lookfrom = {cam[0], cam[1], cam[2]};
  s->lookat = {cam[3], cam[4], cam[5]};
  s->vup = {cam[6], cam[7], cam[8]};
  s->vfov_deg = cam[9];
  s->aperture = cam[10];
  s->focus = cam[11];
  s->has_ambient = has_amb != 0;
  s->ambient = {amb[0], amb[1], amb[2]};
  s->spheres.resize(n);
  for (auto& sp : s->spheres) {
    float g[4];
    int32_t ty;
    float v[8];
    if (std::fread(g, 4, 4, f) != 4 || std::fread(&ty, 4, 1, f) != 1 ||
        std::fread(v, 4, 8, f) != 8) {
      std::fclose(f);
      return false;
    }
    sp.c = {g[0], g[1], g[2]};
    sp.r = g[3];
    sp.ty = ty;
    sp.albedo = {v[0], v[1], v[2]};
    sp.fuzz = v[3];
    sp.ior = v[4];
    sp.emit = {v[5], v[6], v[7]};
  }
  std::fclose(f);
  return true;
}

// -- Mixed scene ("MRTMIX01", meshdump.dump_scene): spheres and triangles
// over one shared (textured) material table — the universal production
// format for `--backend cpu` since round 5 ------------------------------------

struct SphereG {
  Vec c;
  float r;  // signed: negative = inward normals (hollow glass)
  int mat;
};

struct MixScene {
  MeshScene mesh;               // tris + mats + tri BVH + camera/ambient
  std::vector<SphereG> spheres; // leaf-ordered when the BVH is built
  FlatBVH sbvh;
  bool sph_bvh = false;
};

bool load_mix_scene(const char* path, MixScene* s) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "MRTMIX01", 8)) {
    std::fclose(f);
    return false;
  }
  int32_t n_mats = 0, n_tris = 0, n_sph = 0, has_amb = 0;
  float cam[12], amb[3];
  bool ok = std::fread(&n_mats, 4, 1, f) == 1 &&
            std::fread(&n_tris, 4, 1, f) == 1 &&
            std::fread(&n_sph, 4, 1, f) == 1 &&
            std::fread(cam, 4, 12, f) == 12 &&
            std::fread(&has_amb, 4, 1, f) == 1 &&
            std::fread(amb, 4, 3, f) == 3 && n_mats > 0 && n_tris >= 0 &&
            n_sph >= 0 && (n_tris > 0 || n_sph > 0);
  if (ok) {
    // Counts must match the file's actual size (record sizes: material
    // 56 B, triangle 40 B, sphere 20 B): a corrupt/truncated header
    // must fail cleanly here, not throw bad_alloc out of resize()
    // through the extern "C" boundary.
    long header_end = std::ftell(f);
    std::fseek(f, 0, SEEK_END);
    long file_size = std::ftell(f);
    std::fseek(f, header_end, SEEK_SET);
    int64_t expect = int64_t(n_mats) * 56 + int64_t(n_tris) * 40 +
                     int64_t(n_sph) * 20;
    ok = header_end >= 0 && file_size - header_end == expect;
  }
  if (!ok) {
    std::fclose(f);
    return false;
  }
  MeshScene& m = s->mesh;
  m.lookfrom = {cam[0], cam[1], cam[2]};
  m.lookat = {cam[3], cam[4], cam[5]};
  m.vup = {cam[6], cam[7], cam[8]};
  m.vfov_deg = cam[9];
  m.aperture = cam[10];
  m.focus = cam[11];
  m.has_ambient = has_amb != 0;
  m.ambient = {amb[0], amb[1], amb[2]};

  m.mats.resize(n_mats);
  for (auto& mt : m.mats) {
    int32_t ty, tex_ty;
    float v[8], t[4];
    if (std::fread(&ty, 4, 1, f) != 1 || std::fread(v, 4, 8, f) != 8 ||
        std::fread(&tex_ty, 4, 1, f) != 1 || std::fread(t, 4, 4, f) != 4) {
      std::fclose(f);
      return false;
    }
    mt.ty = ty;
    mt.albedo = {v[0], v[1], v[2]};
    mt.fuzz = v[3];
    mt.ior = v[4];
    mt.emit = {v[5], v[6], v[7]};
    mt.tex_ty = tex_ty;
    mt.albedo2 = {t[0], t[1], t[2]};
    mt.tex_scale = t[3];
  }

  if (n_tris > 0) {
    std::vector<Tri> raw(n_tris);
    std::vector<float> pmin(3 * n_tris), pmax(3 * n_tris);
    for (int i = 0; i < n_tris; ++i) {
      float v[9];
      int32_t mat;
      if (std::fread(v, 4, 9, f) != 9 || std::fread(&mat, 4, 1, f) != 1) {
        std::fclose(f);
        return false;
      }
      Vec v0{v[0], v[1], v[2]}, v1{v[3], v[4], v[5]}, v2{v[6], v[7], v[8]};
      raw[i] = {v0, v1 - v0, v2 - v0, mat};
      for (int k = 0; k < 3; ++k) {
        float a = (&v0.x)[k], b = (&v1.x)[k], c = (&v2.x)[k];
        pmin[3 * i + k] = std::min(a, std::min(b, c));
        pmax[3 * i + k] = std::max(a, std::max(b, c));
      }
    }
    std::vector<int> order;
    m.bvh = build_bvh(pmin, pmax, n_tris, /*max_leaf=*/4, &order);
    m.tris.resize(n_tris);
    for (int j = 0; j < n_tris; ++j) m.tris[j] = raw[order[j]];
  }

  s->spheres.resize(n_sph);
  for (auto& sp : s->spheres) {
    float g[4];
    int32_t mat;
    if (std::fread(g, 4, 4, f) != 4 || std::fread(&mat, 4, 1, f) != 1) {
      std::fclose(f);
      return false;
    }
    sp.c = {g[0], g[1], g[2]};
    sp.r = g[3];
    sp.mat = mat;
  }
  std::fclose(f);

  // Material-id bounds: corrupt ids would index out of the table.
  for (const auto& tr : m.tris)
    if (tr.mat < 0 || tr.mat >= n_mats) return false;
  for (const auto& sp : s->spheres)
    if (sp.mat < 0 || sp.mat >= n_mats) return false;

  s->sph_bvh = n_sph > 64;
  if (s->sph_bvh) {
    std::vector<float> pmin(3 * n_sph), pmax(3 * n_sph);
    for (int i = 0; i < n_sph; ++i) {
      const Vec& c = s->spheres[i].c;
      float r = std::fabs(s->spheres[i].r);
      pmin[3 * i] = c.x - r, pmin[3 * i + 1] = c.y - r, pmin[3 * i + 2] = c.z - r;
      pmax[3 * i] = c.x + r, pmax[3 * i + 1] = c.y + r, pmax[3 * i + 2] = c.z + r;
    }
    std::vector<int> order;
    s->sbvh = build_bvh(pmin, pmax, n_sph, /*max_leaf=*/2, &order);
    std::vector<SphereG> re(n_sph);
    for (int j = 0; j < n_sph; ++j) re[j] = s->spheres[order[j]];
    s->spheres = std::move(re);
  }
  return true;
}

inline bool sphereg_cand(const SphereG& sp, const Vec& o, const Vec& d,
                         float tmin, float best, float* t_out) {
  Vec oc = o - sp.c;
  float b = dot(oc, d);
  float c = dot(oc, oc) - sp.r * sp.r;
  float disc = b * b - c;
  if (disc < 0) return false;
  float sq = std::sqrt(disc);
  float t = -b - sq;
  if (t < tmin || t >= best) t = -b + sq;
  if (t < tmin || t >= best) return false;
  *t_out = t;
  return true;
}

// Combined closest hit over both kinds. Winner: idx into tris when
// *is_tri, else into spheres.
bool mix_hit(const MixScene& s, const Vec& o, const Vec& d, float tmin,
             float tmax, Hit* out, bool* is_tri) {
  float best = tmax;
  int bi = -1;
  bool tri = false;
  Hit h;
  if (!s.mesh.tris.empty() && mesh_hit(s.mesh, o, d, tmin, best, &h)) {
    best = h.t;
    bi = h.idx;
    tri = true;
  }
  if (s.sph_bvh) {
    Vec invd{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    int i = 0;
    const int m = s.sbvh.m;
    while (i < m) {
      if (aabb_hit(&s.sbvh.nmin[3 * i], &s.sbvh.nmax[3 * i], o, invd, tmin,
                   best)) {
        int cnt = s.sbvh.count[i];
        if (cnt > 0) {
          int first = s.sbvh.first[i];
          for (int j = first; j < first + cnt; ++j) {
            float t;
            if (sphereg_cand(s.spheres[j], o, d, tmin, best, &t)) {
              best = t;
              bi = j;
              tri = false;
            }
          }
          i = s.sbvh.skip[i];
        } else {
          ++i;
        }
      } else {
        i = s.sbvh.skip[i];
      }
    }
  } else {
    for (size_t j = 0; j < s.spheres.size(); ++j) {
      float t;
      if (sphereg_cand(s.spheres[j], o, d, tmin, best, &t)) {
        best = t;
        bi = int(j);
        tri = false;
      }
    }
  }
  if (bi < 0) return false;
  out->t = best;
  out->idx = bi;
  *is_tri = tri;
  return true;
}

Vec sky(float y) {
  float t = 0.5f * y + 0.5f;
  return Vec{1, 1, 1} * (1 - t) + Vec{0.5f, 0.7f, 1.0f} * t;
}

Vec reflect(const Vec& v, const Vec& n) { return v - n * (2 * dot(v, n)); }

// Shared scatter step (RTiOW semantics, matching the reference's material
// contracts shader.wgsl:198-252 and the dielectric extension). Returns
// false when the path terminates; *radiance then holds the path's value.
bool scatter(const Material& mt, const Vec& d, const Vec& n, bool front,
             Rng& rng, Vec* atten, Vec* nd, Vec* radiance) {
  if (mt.ty == LAMB) {
    *nd = n + rng.unit_sphere();
    if (dot(*nd, *nd) == 0) *nd = n;
    *atten = *atten * mt.albedo;
  } else if (mt.ty == METAL) {
    *nd = reflect(d, n) + rng.unit_ball() * mt.fuzz;
    if (dot(*nd, n) <= 0) {
      *radiance = {0, 0, 0};
      return false;
    }
    *atten = *atten * mt.albedo;
  } else if (mt.ty == LIGHT) {
    *radiance = *atten * mt.emit;
    return false;
  } else {  // DIEL
    float ratio = front ? 1.0f / mt.ior : mt.ior;
    float cost = std::min(-dot(d, n), 1.0f);
    float sint = std::sqrt(std::max(0.0f, 1 - cost * cost));
    float r0 = (1 - ratio) / (1 + ratio);
    r0 *= r0;
    float refl = r0 + (1 - r0) * std::pow(1 - cost, 5.0f);
    if (ratio * sint > 1.0f || refl > rng.f()) {
      *nd = reflect(d, n);
    } else {
      Vec perp = (d + n * cost) * ratio;
      Vec par = n * -std::sqrt(std::fabs(1 - dot(perp, perp)));
      *nd = perp + par;
    }
  }
  return true;
}

Vec trace_spheres(const std::vector<Sphere>& w, const SphereBVH* bvh, Vec o,
                  Vec d, int depth, Rng& rng, uint64_t* segs,
                  bool has_ambient = false, Vec ambient = {0, 0, 0},
                  float tmin = 1e-3f, float tmax = 1e4f) {
  Vec atten{1, 1, 1};
  for (int i = 0; i < depth; ++i) {
    ++*segs;
    Hit h;
    bool hit = bvh ? sphere_bvh_hit(*bvh, o, d, tmin, tmax, &h)
                   : world_hit(w, o, d, tmin, tmax, &h);
    if (!hit) return atten * (has_ambient ? ambient : sky(d.y));
    const Sphere& s = bvh ? bvh->spheres[h.idx] : w[h.idx];
    Vec p = o + d * h.t;
    Vec n = (p - s.c) * (1.0f / s.r);
    bool front = dot(n, d) <= 0;
    if (!front) n = n * -1.0f;
    Material mt;
    mt.ty = s.ty;
    mt.albedo = s.albedo;
    mt.fuzz = s.fuzz;
    mt.ior = s.ior;
    mt.emit = s.emit;
    Vec nd, radiance;
    if (!scatter(mt, d, n, front, rng, &atten, &nd, &radiance)) return radiance;
    o = p;
    d = norm(nd);
  }
  return {0, 0, 0};
}

Vec trace_mesh(const MeshScene& s, Vec o, Vec d, int depth, Rng& rng,
               uint64_t* segs, float tmin = 1e-3f, float tmax = 1e4f) {
  Vec atten{1, 1, 1};
  for (int i = 0; i < depth; ++i) {
    ++*segs;
    Hit h;
    if (!mesh_hit(s, o, d, tmin, tmax, &h))
      return atten * (s.has_ambient ? s.ambient : sky(d.y));
    const Tri& tr = s.tris[h.idx];
    Vec p = o + d * h.t;
    Vec n = norm(cross(tr.e1, tr.e2));
    bool front = dot(n, d) <= 0;
    if (!front) n = n * -1.0f;
    Vec nd, radiance;
    if (!scatter(s.mats[tr.mat], d, n, front, rng, &atten, &nd, &radiance))
      return radiance;
    o = p;
    d = norm(nd);
  }
  return {0, 0, 0};
}

Vec trace_mix(const MixScene& s, Vec o, Vec d, int depth, Rng& rng,
              uint64_t* segs, float tmin = 1e-3f, float tmax = 1e4f) {
  Vec atten{1, 1, 1};
  for (int i = 0; i < depth; ++i) {
    ++*segs;
    Hit h;
    bool is_tri;
    if (!mix_hit(s, o, d, tmin, tmax, &h, &is_tri))
      return atten * (s.mesh.has_ambient ? s.mesh.ambient : sky(d.y));
    Vec p = o + d * h.t;
    Vec n;
    int mid;
    if (is_tri) {
      const Tri& tr = s.mesh.tris[h.idx];
      n = norm(cross(tr.e1, tr.e2));
      mid = tr.mat;
    } else {
      const SphereG& sp = s.spheres[h.idx];
      n = (p - sp.c) * (1.0f / sp.r);  // signed r: inward normals
      mid = sp.mat;
    }
    bool front = dot(n, d) <= 0;
    if (!front) n = n * -1.0f;
    Material mt = s.mesh.mats[mid];
    if (mt.tex_ty != TEX_SOLID) mt.albedo = tex_albedo(mt, p);
    Vec nd, radiance;
    if (!scatter(mt, d, n, front, rng, &atten, &nd, &radiance)) return radiance;
    o = p;
    d = norm(nd);
  }
  return {0, 0, 0};
}

struct CamBasis {
  Vec origin, llc, horiz, vert, cu, cv;
  float lens_r;
};

CamBasis make_camera(Vec lookfrom, Vec lookat, Vec vup, float vfov_deg,
                     float aperture, float focus, float aspect) {
  float h = std::tan(vfov_deg * 3.14159265f / 180 / 2);
  float vph = 2 * h, vpw = aspect * vph;
  Vec cw = norm(lookfrom - lookat);
  Vec cu = norm(cross(vup, cw));
  Vec cv = cross(cw, cu);
  CamBasis c;
  c.origin = lookfrom;
  c.cu = cu;
  c.cv = cv;
  c.horiz = cu * (focus * vpw);
  c.vert = cv * (focus * vph);
  c.llc = lookfrom - c.horiz * 0.5f - c.vert * 0.5f - cw * focus;
  c.lens_r = aperture * 0.5f;
  return c;
}

// -- Loaded scene + frame renderer (shared by main() and the C API) ----------

struct CpuScene {
  int kind = 0;  // 0 = spheres, 1 = mesh, 2 = mixed ("MRTMIX01")
  MeshScene mesh;
  std::vector<Sphere> world;
  SphereBVH sbvh;
  MixScene mix;
  bool use_bvh = false;
  bool has_ambient = false;
  Vec ambient{0, 0, 0};
  // Dump camera (used when no packed runtime camera is supplied).
  Vec lookfrom, lookat, vup;
  float vfov_deg = 20, aperture = 0, focus = 10;
};

CamBasis basis_from_packed(const float* c) {
  // render/camera.py pack_camera layout: llc[0:3], horizontal[3:6],
  // vertical[6:9], origin[9:12], u[12:15], v[15:18], lens_radius[18].
  CamBasis b;
  b.llc = {c[0], c[1], c[2]};
  b.horiz = {c[3], c[4], c[5]};
  b.vert = {c[6], c[7], c[8]};
  b.origin = {c[9], c[10], c[11]};
  b.cu = {c[12], c[13], c[14]};
  b.cv = {c[15], c[16], c[17]};
  b.lens_r = c[18];
  return b;
}

// Render one frame of `spp` samples/pixel into out_rgb ([H*W*3] f32,
// per-pixel means, linear radiance). Deterministic for a given seed:
// each row's RNG is mix64(seed ^ row-mix), independent of threading.
// Returns traced segment count (one per bounce-loop iteration, the TPU
// kernel's convention).
uint64_t render_frame(const CpuScene& s, int W, int H, int spp, int depth,
                      uint64_t seed, float tmin, float tmax,
                      const float* cam19, int threads, float* out_rgb) {
  CamBasis cam = cam19 ? basis_from_packed(cam19)
                       : make_camera(s.lookfrom, s.lookat, s.vup, s.vfov_deg,
                                     s.aperture, s.focus, float(W) / H);
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 1;
  }
  std::atomic<uint64_t> total_segs{0};
  std::atomic<int> next_row{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&]() {
      uint64_t segs = 0;
      int row;
      while ((row = next_row.fetch_add(1)) < H) {
        Rng rng(mix64(seed ^ mix64(uint64_t(row) + 1)));
        for (int x = 0; x < W; ++x) {
          Vec acc{0, 0, 0};
          for (int sIdx = 0; sIdx < spp; ++sIdx) {
            float sx = (x + rng.f()) / W;
            float sy = 1.0f - (row + rng.f()) / H;
            Vec o = cam.origin;
            if (cam.lens_r > 0) {
              float dx, dy;
              rng.unit_disk(dx, dy);
              o = o + cam.cu * (cam.lens_r * dx) + cam.cv * (cam.lens_r * dy);
            }
            Vec d = norm(cam.llc + cam.horiz * sx + cam.vert * sy - o);
            Vec c = s.kind == 2
                        ? trace_mix(s.mix, o, d, depth, rng, &segs, tmin, tmax)
                    : s.kind == 1
                        ? trace_mesh(s.mesh, o, d, depth, rng, &segs, tmin, tmax)
                        : trace_spheres(s.world, s.use_bvh ? &s.sbvh : nullptr,
                                        o, d, depth, rng, &segs, s.has_ambient,
                                        s.ambient, tmin, tmax);
            acc = acc + c;
          }
          float* px = &out_rgb[(size_t(row) * W + x) * 3];
          px[0] = acc.x / spp;
          px[1] = acc.y / spp;
          px[2] = acc.z / spp;
        }
      }
      total_segs += segs;
    });
  }
  for (auto& th : pool) th.join();
  return total_segs.load();
}

}  // namespace

// -- C API (ctypes, myraytracer_tpu/native/cpu_backend.py) -------------------

extern "C" {

// Load a scene dump (sniffs the magic: "MRTMIX01" — the universal
// production format, spheres+meshes+textures — or the legacy single-kind
// "MRTMESH1"/"MRTSPH01" bench formats; all meshdump.py). Sphere scenes
// always build the SAH BVH — this is the production path, not the
// brute-force baseline mode. Returns NULL on failure.
void* mrt_cpu_scene_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  size_t got = std::fread(magic, 1, 8, f);
  std::fclose(f);
  if (got != 8) return nullptr;
  auto* s = new CpuScene();
  if (!std::memcmp(magic, "MRTMESH1", 8)) {
    if (!load_mesh_scene(path, &s->mesh)) {
      delete s;
      return nullptr;
    }
    s->kind = 1;
    s->lookfrom = s->mesh.lookfrom;
    s->lookat = s->mesh.lookat;
    s->vup = s->mesh.vup;
    s->vfov_deg = s->mesh.vfov_deg;
    s->aperture = s->mesh.aperture;
    s->focus = s->mesh.focus;
  } else if (!std::memcmp(magic, "MRTMIX01", 8)) {
    if (!load_mix_scene(path, &s->mix)) {
      delete s;
      return nullptr;
    }
    s->kind = 2;
    const MeshScene& m = s->mix.mesh;
    s->lookfrom = m.lookfrom;
    s->lookat = m.lookat;
    s->vup = m.vup;
    s->vfov_deg = m.vfov_deg;
    s->aperture = m.aperture;
    s->focus = m.focus;
  } else if (!std::memcmp(magic, "MRTSPH01", 8)) {
    SphereScene ss;
    if (!load_sphere_scene(path, &ss)) {
      delete s;
      return nullptr;
    }
    s->kind = 0;
    s->world = std::move(ss.spheres);
    s->use_bvh = s->world.size() > 64;
    if (s->use_bvh) s->sbvh = build_sphere_bvh(s->world);
    s->has_ambient = ss.has_ambient;
    s->ambient = ss.ambient;
    s->lookfrom = ss.lookfrom;
    s->lookat = ss.lookat;
    s->vup = ss.vup;
    s->vfov_deg = ss.vfov_deg;
    s->aperture = ss.aperture;
    s->focus = ss.focus;
  } else {
    delete s;
    return nullptr;
  }
  return s;
}

void mrt_cpu_scene_free(void* h) { delete static_cast<CpuScene*>(h); }

// kind: 0 = spheres, 1 = mesh, 2 = mixed; n_prims: primitive count.
void mrt_cpu_scene_info(void* h, int* kind, int* n_prims) {
  auto* s = static_cast<CpuScene*>(h);
  *kind = s->kind;
  *n_prims = static_cast<int>(
      s->kind == 2 ? s->mix.mesh.tris.size() + s->mix.spheres.size()
      : s->kind == 1 ? s->mesh.tris.size()
                     : s->world.size());
}

// Render one frame. cam19 may be NULL (use the dump camera at aspect
// W/H); out_rgb must hold W*H*3 floats. Returns 0, with the traced
// segment count in *out_segs.
int mrt_cpu_render(void* h, int width, int height, int spp, int depth,
                   uint64_t seed, float t_min, float t_max,
                   const float* cam19, int threads, float* out_rgb,
                   double* out_segs) {
  if (!h || width <= 0 || height <= 0 || spp <= 0 || depth <= 0) return 1;
  uint64_t segs =
      render_frame(*static_cast<CpuScene*>(h), width, height, spp, depth,
                   seed, t_min, t_max, cam19, threads, out_rgb);
  if (out_segs) *out_segs = static_cast<double>(segs);
  return 0;
}

}  // extern "C"

#ifndef MRT_CPU_LIB

int main(int argc, char** argv) {
  const char* mesh_path = nullptr;
  const char* sph_path = nullptr;
  const char* mix_path = nullptr;
  const char* ppm_path = nullptr;
  bool use_bvh = false;
  std::vector<const char*> pos;
  for (int i = 1; i < argc; ++i) {
    if (!std::strcmp(argv[i], "--mesh") && i + 1 < argc) {
      mesh_path = argv[++i];
    } else if (!std::strcmp(argv[i], "--spheres") && i + 1 < argc) {
      sph_path = argv[++i];  // sphere-scene dump (meshdump.dump_spheres)
    } else if (!std::strcmp(argv[i], "--mix") && i + 1 < argc) {
      mix_path = argv[++i];  // universal dump (meshdump.dump_scene)
    } else if (!std::strcmp(argv[i], "--ppm") && i + 1 < argc) {
      ppm_path = argv[++i];  // gamma-2 P6 dump (baseline correctness check)
    } else if (!std::strcmp(argv[i], "--bvh")) {
      use_bvh = true;
    } else {
      pos.push_back(argv[i]);
    }
  }
  int W = pos.size() > 0 ? std::atoi(pos[0]) : 400;
  int H = pos.size() > 1 ? std::atoi(pos[1]) : 267;
  int spp = pos.size() > 2 ? std::atoi(pos[2]) : 4;
  int depth = pos.size() > 3 ? std::atoi(pos[3]) : 50;
  int threads = pos.size() > 4 ? std::atoi(pos[4])
                               : static_cast<int>(std::thread::hardware_concurrency());

  CpuScene scene;
  size_t n_prims;
  const char* mode;
  if (mix_path) {
    if (!load_mix_scene(mix_path, &scene.mix)) {
      std::fprintf(stderr, "failed to load mixed scene %s\n", mix_path);
      return 2;
    }
    scene.kind = 2;
    const MeshScene& m = scene.mix.mesh;
    scene.lookfrom = m.lookfrom;
    scene.lookat = m.lookat;
    scene.vup = m.vup;
    scene.vfov_deg = m.vfov_deg;
    scene.aperture = m.aperture;
    scene.focus = m.focus;
    n_prims = scene.mix.mesh.tris.size() + scene.mix.spheres.size();
    mode = "cpu-bvh-mixed";
  } else if (mesh_path) {
    if (!load_mesh_scene(mesh_path, &scene.mesh)) {
      std::fprintf(stderr, "failed to load mesh scene %s\n", mesh_path);
      return 2;
    }
    scene.kind = 1;
    scene.lookfrom = scene.mesh.lookfrom;
    scene.lookat = scene.mesh.lookat;
    scene.vup = scene.mesh.vup;
    scene.vfov_deg = scene.mesh.vfov_deg;
    scene.aperture = scene.mesh.aperture;
    scene.focus = scene.mesh.focus;
    n_prims = scene.mesh.tris.size();
    mode = "cpu-bvh-mesh";
  } else if (sph_path) {
    SphereScene ss;
    if (!load_sphere_scene(sph_path, &ss)) {
      std::fprintf(stderr, "failed to load sphere scene %s\n", sph_path);
      return 2;
    }
    scene.world = std::move(ss.spheres);
    scene.has_ambient = ss.has_ambient;
    scene.ambient = ss.ambient;
    if (use_bvh || scene.world.size() > 64) {
      use_bvh = true;  // dumps are the scaling surface: strong baseline
      scene.use_bvh = true;
      scene.sbvh = build_sphere_bvh(scene.world);
    }
    scene.lookfrom = ss.lookfrom;
    scene.lookat = ss.lookat;
    scene.vup = ss.vup;
    scene.vfov_deg = ss.vfov_deg;
    scene.aperture = ss.aperture;
    scene.focus = ss.focus;
    n_prims = scene.world.size();
    mode = use_bvh ? "cpu-bvh-spheres" : "cpu-bruteforce-spheres";
  } else {
    scene.world = final_scene();
    scene.use_bvh = use_bvh;
    if (use_bvh) scene.sbvh = build_sphere_bvh(scene.world);
    // Camera: lookfrom (13,2,3) → (0,0,0), vfov 20, focus 10, aperture 0.1.
    scene.lookfrom = {13, 2, 3};
    scene.lookat = {0, 0, 0};
    scene.vup = {0, 1, 0};
    scene.vfov_deg = 20.0f;
    scene.aperture = 0.1f;
    scene.focus = 10.0f;
    n_prims = scene.world.size();
    mode = use_bvh ? "cpu-bvh" : "cpu-bruteforce";
  }

  std::vector<float> fb(size_t(W) * H * 3, 0.0f);  // per-pixel means
  auto t0 = std::chrono::steady_clock::now();
  uint64_t segs = render_frame(scene, W, H, spp, depth, /*seed=*/0, 1e-3f,
                               1e4f, /*cam19=*/nullptr, threads, fb.data());
  double dt =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  if (ppm_path) {
    // Gamma-2 P6, the framework's output/image.py convention.
    FILE* f = std::fopen(ppm_path, "wb");
    if (f) {
      std::fprintf(f, "P6\n%d %d\n255\n", W, H);
      for (size_t i = 0; i < fb.size(); ++i) {
        float v = std::sqrt(std::min(std::max(fb[i], 0.0f), 1.0f));
        unsigned char b = (unsigned char)std::min(255.0f, v * 255.0f + 0.5f);
        std::fwrite(&b, 1, 1, f);
      }
      std::fclose(f);
    }
  }
  std::printf(
      "{\"renderer\": \"%s\", \"prims\": %zu, \"width\": %d, \"height\": %d, "
      "\"spp\": %d, \"depth\": %d, \"threads\": %d, \"seconds\": %.3f, "
      "\"segments\": %llu, \"mrays_per_s\": %.3f}\n",
      mode, n_prims, W, H, spp, depth, threads, dt, (unsigned long long)segs,
      segs / dt / 1e6);
  return 0;
}

#endif  // MRT_CPU_LIB
