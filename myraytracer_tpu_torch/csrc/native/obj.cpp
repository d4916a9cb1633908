// Native OBJ mesh loader (vertices + triangulated faces).
//
// Minimal Wavefront-OBJ subset: `v x y z` and `f i j k ...` records
// (polygon faces fan-triangulated; negative indices resolved relative to
// the current vertex count, 1-based positive indices; `i/t/n` forms take
// the vertex index before the first slash). Everything else is skipped.
//
// Fills the framework's "native data loader" slot (the reference's runtime
// layer is native Rust; its scenes are hard-coded, lib.rs:687-720, so mesh
// IO is an extension). C ABI for ctypes; Python fallback in
// myraytracer_tpu/native/obj_py.py with identical semantics.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> vertices;  // xyz triples
  std::vector<int> triangles;   // index triples
};

int parse_index(const char* tok, int n_vertices) {
  // "7", "7/1", "7//3", "-2" → 0-based vertex index or -1.
  long v = std::strtol(tok, nullptr, 10);
  if (v > 0) return static_cast<int>(v - 1);
  if (v < 0) return n_vertices + static_cast<int>(v);
  return -1;
}

bool parse(FILE* f, ObjData* out) {
  char line[4096];
  while (std::fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        out->vertices.push_back(x);
        out->vertices.push_back(y);
        out->vertices.push_back(z);
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      int idx[64];
      int n = 0;
      int nv = static_cast<int>(out->vertices.size() / 3);
      char* save = nullptr;
      for (char* tok = strtok_r(line + 2, " \t\r\n", &save);
           tok && n < 64; tok = strtok_r(nullptr, " \t\r\n", &save)) {
        int v = parse_index(tok, nv);
        if (v >= 0 && v < nv) idx[n++] = v;
      }
      for (int k = 2; k < n; ++k) {  // fan triangulation
        out->triangles.push_back(idx[0]);
        out->triangles.push_back(idx[k - 1]);
        out->triangles.push_back(idx[k]);
      }
    }
  }
  return true;
}

ObjData* g_last = nullptr;

}  // namespace

extern "C" {

// Parse; returns 0 on success and reports sizes. Data is fetched with
// mrt_obj_read and released with mrt_obj_free (single in-flight parse).
int mrt_obj_open(const char* path, int* n_vertices, int* n_triangles) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  delete g_last;
  g_last = new ObjData();
  bool ok = parse(f, g_last);
  std::fclose(f);
  if (!ok) {
    delete g_last;
    g_last = nullptr;
    return -2;
  }
  *n_vertices = static_cast<int>(g_last->vertices.size() / 3);
  *n_triangles = static_cast<int>(g_last->triangles.size() / 3);
  return 0;
}

int mrt_obj_read(float* vertices, int* triangles) {
  if (!g_last) return -1;
  std::memcpy(vertices, g_last->vertices.data(),
              g_last->vertices.size() * sizeof(float));
  std::memcpy(triangles, g_last->triangles.data(),
              g_last->triangles.size() * sizeof(int));
  return 0;
}

void mrt_obj_free() {
  delete g_last;
  g_last = nullptr;
}

}  // extern "C"
