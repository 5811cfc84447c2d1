// Per-ray wide-BVH traversal: the body of the GPU kernel, written as plain
// C++ so that it also compiles for the host (TK_HD empty) in checks of its
// arithmetic against the jnp reference, geometry/traverse.py::_traverse.
//
// One thread owns one ray and a short stack of (node, entry distance)
// pairs. Node and triangle tables are read from global memory (they sit in
// L2 at the scene sizes the renderer ships). Children are visited
// near-first; a popped node whose entry distance exceeds the ray's current
// best t is skipped; any-hit queries stop at the first accepted triangle.
//
// Every test uses the reference's expressions in the same order: the slab
// test of traverse.py::_slab_test, the Moller-Trumbore leaf test of
// traverse.py::_leaf_test, and its tie rule (equal t -> lower primitive
// index), so the closest hit does not depend on the visiting order.
#pragma once

#include <cstdint>

#ifndef TK_HD
#define TK_HD __device__ __forceinline__
#endif
#ifndef TK_LDG
#define TK_LDG(p) __ldg(p)
#endif

namespace take {

constexpr int kWidth = 8;       // bvh.py WIDTH
constexpr int kLeafSize = 16;   // bvh.py LEAF_SIZE
constexpr int kStack = 64;      // traverse.py STACK
constexpr float kBig = 3.4e38f;

struct TraverseParams {
  const float* ro;          // [N, 3]
  const float* rd;          // [N, 3]
  const float* tmin;        // [N]
  const float* tmax;        // [N]
  const float* node_min;    // [M, W, 3]
  const float* node_max;    // [M, W, 3]
  const int32_t* node_child;  // [M, W]
  const int32_t* node_count;  // [M, W]
  const float* v0;          // [T, 3]
  const float* e1;          // [T, 3]
  const float* e2;          // [T, 3]
  int64_t n_rays;
  int32_t n_tri_rows;       // T (leaf indices are clipped to T - 1)
  int32_t any_hit;
  float* t_out;             // [N]
  float* u_out;             // [N]
  float* v_out;             // [N]
  int32_t* prim_out;        // [N], -1 on a miss
};

struct V3 {
  float x, y, z;
};

TK_HD V3 load3(const float* p, int64_t i) {
  return V3{TK_LDG(p + 3 * i), TK_LDG(p + 3 * i + 1), TK_LDG(p + 3 * i + 2)};
}

TK_HD V3 cross(V3 a, V3 b) {  // jnp.cross component order
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

TK_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

TK_HD float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? 1e-20f : d);
}

TK_HD void traverse_ray(const TraverseParams& p, int64_t i) {
  const V3 ro = load3(p.ro, i);
  const V3 rd = load3(p.rd, i);
  const V3 inv = V3{inv_dir(rd.x), inv_dir(rd.y), inv_dir(rd.z)};
  const float tmin = p.tmin[i];

  float best_t = p.tmax[i];
  float best_u = 0.0f, best_v = 0.0f;
  int32_t best_prim = -1;
  bool found = false;

  int32_t stack_node[kStack];
  float stack_t[kStack];
  int sp = 0;
  stack_node[sp] = 0;
  stack_t[sp] = -kBig;
  ++sp;

  while (sp > 0) {
    --sp;
    const int32_t node = stack_node[sp];
    if (stack_t[sp] > best_t) continue;  // entered beyond the best hit

    // slab-test all children against the current best t
    int32_t push_node[kWidth];
    float push_t[kWidth];
    int n_push = 0;
    for (int w = 0; w < kWidth; ++w) {
      const int64_t slot = static_cast<int64_t>(node) * kWidth + w;
      const int32_t child = TK_LDG(p.node_child + slot);
      const int32_t count = TK_LDG(p.node_count + slot);
      if (child < 0 && count <= 0) continue;  // empty slot
      const V3 bmin = load3(p.node_min, slot);
      const V3 bmax = load3(p.node_max, slot);
      const float tx0 = (bmin.x - ro.x) * inv.x, tx1 = (bmax.x - ro.x) * inv.x;
      const float ty0 = (bmin.y - ro.y) * inv.y, ty1 = (bmax.y - ro.y) * inv.y;
      const float tz0 = (bmin.z - ro.z) * inv.z, tz1 = (bmax.z - ro.z) * inv.z;
      const float tlo = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                              fminf(tz0, tz1));
      const float thi = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                              fmaxf(tz0, tz1));
      if (!((tlo <= thi) && (thi >= tmin) && (tlo <= best_t))) continue;

      if (child >= 0) {
        // insertion-sort by entry distance, farthest first
        int k = n_push;
        while (k > 0 && push_t[k - 1] < tlo) {
          push_node[k] = push_node[k - 1];
          push_t[k] = push_t[k - 1];
          --k;
        }
        push_node[k] = child;
        push_t[k] = tlo;
        ++n_push;
        continue;
      }

      // leaf: test its contiguous triangle run
      const int32_t start = -(child + 1);
      const int32_t n = count < kLeafSize ? count : kLeafSize;
      for (int k = 0; k < n; ++k) {
        int32_t idx = start + k;
        if (idx > p.n_tri_rows - 1) idx = p.n_tri_rows - 1;
        const V3 v0 = load3(p.v0, idx);
        const V3 e1 = load3(p.e1, idx);
        const V3 e2 = load3(p.e2, idx);
        const V3 h = cross(rd, e2);
        const float a = dot(e1, h);
        const bool parallel = fabsf(a) < 1e-12f;
        const float f = 1.0f / (parallel ? 1.0f : a);
        const V3 s = V3{ro.x - v0.x, ro.y - v0.y, ro.z - v0.z};
        const float u = f * dot(s, h);
        const V3 q = cross(s, e1);
        const float v = f * dot(rd, q);
        const float t = f * dot(e2, q);
        const bool ok = !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                        u + v <= 1.0f && t >= tmin && t <= best_t;
        if (ok && (t < best_t || (found && idx < best_prim))) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_prim = idx;
          found = true;
          if (p.any_hit) break;
        }
      }
      if (p.any_hit && found) break;
    }
    if (p.any_hit && found) break;

    // push farthest first, so the nearest child is popped next
    for (int k = 0; k < n_push; ++k) {
      const int slot = sp < kStack ? sp : kStack - 1;
      stack_node[slot] = push_node[k];
      stack_t[slot] = push_t[k];
      sp = sp + 1 < kStack ? sp + 1 : kStack;
    }
  }

  p.t_out[i] = best_t;
  p.u_out[i] = best_u;
  p.v_out[i] = best_v;
  p.prim_out[i] = found ? best_prim : -1;
}

}  // namespace take
