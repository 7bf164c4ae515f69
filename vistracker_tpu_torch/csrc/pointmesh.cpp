// Exact point-to-mesh distance queries over a triangle BVH (host code).
//
// The port's copy of the JAX package's native/pointmesh.cpp: the GT
// labelling of SIF-Net's training samples (unsigned distance + closest
// surface point + face id, in place of the reference's
// igl.signed_distance) for large query batches against the SMPL and
// object meshes, on the host CPU.
//
// Median-split AABB BVH, branch-and-bound nearest-triangle search, exact
// closest-point-on-triangle (Ericson RTCD 5.1.5). Queries are thread-safe.
//
// Built at first use by utils/cuda_build.py:load_host_library:
//   g++ -O3 -shared -fPIC -std=c++17 -o build/kernels/libpointmesh_<hash>.so \
//       csrc/pointmesh.cpp

#include <cstdint>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

struct Vec3 {
    float x, y, z;
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
};
inline float dot(const Vec3& a, const Vec3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline float sqnorm(const Vec3& a) { return dot(a, a); }

// closest point on triangle (a, b, c) to p
Vec3 closestOnTri(const Vec3& p, const Vec3& a, const Vec3& b, const Vec3& c) {
    Vec3 ab = b - a, ac = c - a, ap = p - a;
    float d1 = dot(ab, ap), d2 = dot(ac, ap);
    if (d1 <= 0.f && d2 <= 0.f) return a;
    Vec3 bp = p - b;
    float d3 = dot(ab, bp), d4 = dot(ac, bp);
    if (d3 >= 0.f && d4 <= d3) return b;
    float vc = d1 * d4 - d3 * d2;
    if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {
        float v = d1 / (d1 - d3);
        return a + ab * v;
    }
    Vec3 cp = p - c;
    float d5 = dot(ab, cp), d6 = dot(ac, cp);
    if (d6 >= 0.f && d5 <= d6) return c;
    float vb = d5 * d2 - d1 * d6;
    if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {
        float w = d2 / (d2 - d6);
        return a + ac * w;
    }
    float va = d3 * d6 - d5 * d4;
    if (va <= 0.f && (d4 - d3) >= 0.f && (d5 - d6) >= 0.f) {
        float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
        return b + (c - b) * w;
    }
    float denom = 1.f / (va + vb + vc);
    float v = vb * denom, w = vc * denom;
    return a + ab * v + ac * w;
}

struct AABB {
    Vec3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
    void grow(const Vec3& p) {
        lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y);
        lo.z = std::min(lo.z, p.z);
        hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y);
        hi.z = std::max(hi.z, p.z);
    }
    void grow(const AABB& o) { grow(o.lo); grow(o.hi); }
    float sqdist(const Vec3& p) const {
        float d = 0.f;
        auto axis = [&](float v, float l, float h) {
            float e = (v < l) ? l - v : (v > h ? v - h : 0.f);
            return e * e;
        };
        d += axis(p.x, lo.x, hi.x);
        d += axis(p.y, lo.y, hi.y);
        d += axis(p.z, lo.z, hi.z);
        return d;
    }
};

struct Node {
    AABB box;
    int32_t left = -1, right = -1;   // children (internal) or
    int32_t first = 0, count = 0;    // triangle range (leaf)
};

struct BVH {
    std::vector<Vec3> va, vb, vc;    // triangle verts, reordered
    std::vector<int32_t> tri_idx;    // original face index per slot
    std::vector<Node> nodes;

    int32_t build(std::vector<int32_t>& order,
                  const std::vector<Vec3>& cent,
                  const std::vector<AABB>& boxes, int lo, int hi) {
        Node node;
        for (int i = lo; i < hi; ++i) node.box.grow(boxes[order[i]]);
        int32_t idx = (int32_t)nodes.size();
        nodes.push_back(node);
        if (hi - lo <= 4) {
            nodes[idx].first = lo;
            nodes[idx].count = hi - lo;
            return idx;
        }
        // split along the longest axis at the median centroid
        Vec3 ext = node.box.hi - node.box.lo;
        int axis = (ext.x > ext.y && ext.x > ext.z) ? 0
                   : (ext.y > ext.z ? 1 : 2);
        int mid = (lo + hi) / 2;
        std::nth_element(order.begin() + lo, order.begin() + mid,
                         order.begin() + hi, [&](int32_t a, int32_t b) {
            const Vec3& ca = cent[a];
            const Vec3& cb = cent[b];
            return axis == 0 ? ca.x < cb.x : axis == 1 ? ca.y < cb.y
                                                       : ca.z < cb.z;
        });
        int32_t l = build(order, cent, boxes, lo, mid);
        int32_t r = build(order, cent, boxes, mid, hi);
        nodes[idx].left = l;
        nodes[idx].right = r;
        nodes[idx].count = 0;
        return idx;
    }

    void init(const float* verts, int n_verts, const int32_t* faces,
              int n_faces) {
        (void)n_verts;
        std::vector<Vec3> A(n_faces), B(n_faces), C(n_faces), cent(n_faces);
        std::vector<AABB> boxes(n_faces);
        for (int f = 0; f < n_faces; ++f) {
            auto v = [&](int k) {
                int vi = faces[3 * f + k];
                return Vec3{verts[3 * vi], verts[3 * vi + 1],
                            verts[3 * vi + 2]};
            };
            A[f] = v(0); B[f] = v(1); C[f] = v(2);
            boxes[f].grow(A[f]); boxes[f].grow(B[f]); boxes[f].grow(C[f]);
            cent[f] = (A[f] + B[f] + C[f]) * (1.f / 3.f);
        }
        std::vector<int32_t> order(n_faces);
        for (int i = 0; i < n_faces; ++i) order[i] = i;
        nodes.reserve(2 * n_faces);
        build(order, cent, boxes, 0, n_faces);
        va.resize(n_faces); vb.resize(n_faces); vc.resize(n_faces);
        tri_idx.resize(n_faces);
        for (int i = 0; i < n_faces; ++i) {
            va[i] = A[order[i]]; vb[i] = B[order[i]]; vc[i] = C[order[i]];
            tri_idx[i] = order[i];
        }
    }

    void query(const Vec3& p, float& best_sq, Vec3& best_pt,
               int32_t& best_tri) const {
        // iterative best-first descent with a small explicit stack
        int32_t stack[128];
        int sp = 0;
        stack[sp++] = 0;
        while (sp > 0) {
            int32_t ni = stack[--sp];
            const Node& n = nodes[ni];
            if (n.box.sqdist(p) >= best_sq) continue;
            if (n.count > 0) {
                for (int i = n.first; i < n.first + n.count; ++i) {
                    Vec3 cp = closestOnTri(p, va[i], vb[i], vc[i]);
                    float d = sqnorm(p - cp);
                    if (d < best_sq) {
                        best_sq = d; best_pt = cp; best_tri = tri_idx[i];
                    }
                }
            } else {
                // visit nearer child first
                float dl = nodes[n.left].box.sqdist(p);
                float dr = nodes[n.right].box.sqdist(p);
                if (dl < dr) {
                    if (sp < 126) { stack[sp++] = n.right; stack[sp++] = n.left; }
                } else {
                    if (sp < 126) { stack[sp++] = n.left; stack[sp++] = n.right; }
                }
            }
        }
    }
};

}  // namespace

extern "C" {

void* pmd_build(const float* verts, int n_verts, const int32_t* faces,
                int n_faces) {
    BVH* bvh = new BVH();
    bvh->init(verts, n_verts, faces, n_faces);
    return bvh;
}

void pmd_query(void* handle, const float* points, int n_points,
               float* out_dist, float* out_closest, int32_t* out_face) {
    const BVH* bvh = static_cast<const BVH*>(handle);
    for (int i = 0; i < n_points; ++i) {
        Vec3 p{points[3 * i], points[3 * i + 1], points[3 * i + 2]};
        float best = std::numeric_limits<float>::max();
        Vec3 cp{0, 0, 0};
        int32_t tri = -1;
        bvh->query(p, best, cp, tri);
        out_dist[i] = std::sqrt(best);
        if (out_closest) {
            out_closest[3 * i] = cp.x;
            out_closest[3 * i + 1] = cp.y;
            out_closest[3 * i + 2] = cp.z;
        }
        if (out_face) out_face[i] = tri;
    }
}

void pmd_free(void* handle) { delete static_cast<BVH*>(handle); }

}  // extern "C"
