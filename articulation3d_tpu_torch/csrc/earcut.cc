// Ear-clipping triangulation of a simple polygon, for the plane -> mesh
// export of articulation3d_tpu_torch (export/mesh.py).
//
// The same algorithm, line for line, as arti3d_earcut in the JAX package's
// native library, so both packages give the same triangles. Built at first
// use by articulation3d_tpu_torch/native.py:
//   g++ -O3 -fPIC -std=c++17 -shared -o libearcut_<digest>.so earcut.cc

#include <vector>

namespace {

struct Node {
  int idx;      // index into the original vertex array
  int prev;
  int next;
};

inline double cross(double ox, double oy, double ax, double ay, double bx,
                    double by) {
  return (ax - ox) * (by - oy) - (ay - oy) * (bx - ox);
}

inline bool point_in_triangle(double px, double py, double ax, double ay,
                              double bx, double by, double cx, double cy) {
  const double d1 = cross(ax, ay, bx, by, px, py);
  const double d2 = cross(bx, by, cx, cy, px, py);
  const double d3 = cross(cx, cy, ax, ay, px, py);
  const bool has_neg = (d1 < 0) || (d2 < 0) || (d3 < 0);
  const bool has_pos = (d1 > 0) || (d2 > 0) || (d3 > 0);
  return !(has_neg && has_pos);
}

}  // namespace

extern "C" {

// Triangulate a simple polygon (n >= 3 vertices, (x, y) pairs).
// out_tris must hold 3 * (n - 2) ints. Returns the number of triangles
// written (may be < n - 2 for degenerate inputs).
int arti3d_earcut(const float* verts, int n, int* out_tris) {
  if (n < 3) return 0;

  // signed area -> winding
  double area = 0.0;
  for (int i = 0, j = n - 1; i < n; j = i++) {
    area += (double)verts[2 * j] * verts[2 * i + 1] -
            (double)verts[2 * i] * verts[2 * j + 1];
  }
  const bool ccw = area > 0.0;  // positive signed area in (x, y-down) terms

  std::vector<Node> nodes(n);
  for (int i = 0; i < n; ++i) {
    nodes[i].idx = i;
    nodes[i].prev = (i + n - 1) % n;
    nodes[i].next = (i + 1) % n;
  }

  int remaining = n;
  int cur = 0;
  int tri_count = 0;
  int guard = 0;
  const int max_guard = 2 * n * n + 16;

  while (remaining > 3 && guard++ < max_guard) {
    const Node& c = nodes[cur];
    const int ip = nodes[c.prev].idx, ic = c.idx, in = nodes[c.next].idx;
    const double ax = verts[2 * ip], ay = verts[2 * ip + 1];
    const double bx = verts[2 * ic], by = verts[2 * ic + 1];
    const double cx = verts[2 * in], cy = verts[2 * in + 1];

    double cr = cross(ax, ay, bx, by, cx, cy);
    bool convex = ccw ? (cr > 0) : (cr < 0);
    bool is_ear = convex;
    if (is_ear) {
      // no other remaining vertex may lie inside the candidate ear
      for (int k = nodes[c.next].next; k != c.prev; k = nodes[k].next) {
        const int iq = nodes[k].idx;
        if (point_in_triangle(verts[2 * iq], verts[2 * iq + 1], ax, ay, bx, by,
                              cx, cy)) {
          is_ear = false;
          break;
        }
      }
    }
    if (is_ear) {
      out_tris[3 * tri_count] = ip;
      out_tris[3 * tri_count + 1] = ic;
      out_tris[3 * tri_count + 2] = in;
      ++tri_count;
      nodes[c.prev].next = c.next;
      nodes[c.next].prev = c.prev;
      cur = c.next;
      --remaining;
      guard = 0;
    } else {
      cur = c.next;
    }
  }
  if (remaining == 3) {
    const Node& c = nodes[cur];
    out_tris[3 * tri_count] = nodes[c.prev].idx;
    out_tris[3 * tri_count + 1] = c.idx;
    out_tris[3 * tri_count + 2] = nodes[c.next].idx;
    ++tri_count;
  }
  return tri_count;
}

}  // extern "C"
