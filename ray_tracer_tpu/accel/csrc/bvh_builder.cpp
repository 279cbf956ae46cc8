// Native binned-SAH BVH builder + octant threading.
//
// C++ reimplementation of accel/bvh.py (same semantics: BINS=20 sweep,
// leaf <= 2 / depth >= 64 / SAH-no-gain termination mirroring the reference
// src/vk_engine.cpp:1169-1337, median-split fallback bounding leaves at
// max_leaf, contiguous child pairs, 8 octant-threaded hit/miss link tables).
// The numpy builder is fine for the reference's toy meshes but takes minutes
// on Sponza-class inputs; this runs in tenths of a second.  Exposed through
// ctypes (accel/native.py); accel/bvh.py stays the semantic oracle in tests.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int BINS = 20;         // vk_engine.h:203
constexpr int MAX_DEPTH = 64;    // vk_engine.cpp:1215
constexpr int SAH_LEAF = 2;      // vk_engine.cpp:1215
constexpr int32_t SENTINEL = 2147483647;

struct V3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  V3 lo{1e30f, 1e30f, 1e30f};
  V3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const V3 &lo2, const V3 &hi2) {
    lo = vmin(lo, lo2);
    hi = vmax(hi, hi2);
  }
  double area() const {
    double ex = std::max(0.f, hi.x - lo.x);
    double ey = std::max(0.f, hi.y - lo.y);
    double ez = std::max(0.f, hi.z - lo.z);
    return ex * ey + ey * ez + ez * ex;
  }
};

struct Builder {
  // per-triangle (reordered in place)
  std::vector<V3> tmin, tmax, cent;
  std::vector<int64_t> perm;
  int max_leaf;

  // nodes
  std::vector<V3> nmin, nmax;
  std::vector<int32_t> index, count;
  std::vector<int8_t> axis;
  int stats_max_leaf = 1;
  int stats_max_depth = 0;

  int alloc(int n) {
    int base = (int)index.size();
    nmin.resize(base + n);
    nmax.resize(base + n);
    index.resize(base + n, 0);
    count.resize(base + n, 0);
    axis.resize(base + n, 0);
    return base;
  }

  void set_bounds(int node, int lo, int hi) {
    Box b;
    for (int i = lo; i < hi; i++) b.grow(tmin[i], tmax[i]);
    nmin[node] = b.lo;
    nmax[node] = b.hi;
  }

  // returns (cost, axis, split) — cost=inf when no valid split
  bool find_split(int lo, int hi, double &best_cost, int &best_axis,
                  float &best_split) const {
    best_cost = std::numeric_limits<double>::infinity();
    best_axis = -1;
    for (int a = 0; a < 3; a++) {
      float cmin = 1e30f, cmax = -1e30f;
      for (int i = lo; i < hi; i++) {
        cmin = std::min(cmin, cent[i][a]);
        cmax = std::max(cmax, cent[i][a]);
      }
      if (cmin == cmax) continue;
      float scale = BINS / (cmax - cmin);
      Box bins[BINS];
      int cnt[BINS] = {0};
      for (int i = lo; i < hi; i++) {
        int bi = std::min(BINS - 1, (int)std::floor((cent[i][a] - cmin) * scale));
        cnt[bi]++;
        bins[bi].grow(tmin[i], tmax[i]);
      }
      double larea[BINS - 1], rarea[BINS - 1];
      int64_t lcnt[BINS - 1], rcnt[BINS - 1];
      Box lb, rb;
      int64_t ls = 0, rs = 0;
      for (int i = 0; i < BINS - 1; i++) {
        ls += cnt[i];
        lcnt[i] = ls;
        lb.grow(bins[i].lo, bins[i].hi);
        larea[i] = lb.area();
        rs += cnt[BINS - 1 - i];
        rcnt[BINS - 2 - i] = rs;
        rb.grow(bins[BINS - 1 - i].lo, bins[BINS - 1 - i].hi);
        rarea[BINS - 2 - i] = rb.area();
      }
      for (int i = 0; i < BINS - 1; i++) {
        if (lcnt[i] == 0 || rcnt[i] == 0) continue;
        double cost = lcnt[i] * larea[i] + rcnt[i] * rarea[i];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = a;
          best_split = cmin + (cmax - cmin) / BINS * (i + 1);
        }
      }
    }
    return best_axis >= 0;
  }

  void swap_tri(int i, int j) {
    std::swap(tmin[i], tmin[j]);
    std::swap(tmax[i], tmax[j]);
    std::swap(cent[i], cent[j]);
    std::swap(perm[i], perm[j]);
  }

  int partition(int lo, int hi, int a, float split) {
    int i = lo, j = hi - 1;
    while (i <= j) {
      if (cent[i][a] < split) {
        i++;
      } else {
        swap_tri(i, j);
        j--;
      }
    }
    return i;
  }

  int median_split(int lo, int hi, int &a_out) {
    V3 cmin{1e30f, 1e30f, 1e30f}, cmax{-1e30f, -1e30f, -1e30f};
    for (int i = lo; i < hi; i++) {
      cmin = vmin(cmin, cent[i]);
      cmax = vmax(cmax, cent[i]);
    }
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int a = 0;
    if (ext[1] > ext[a]) a = 1;
    if (ext[2] > ext[a]) a = 2;
    a_out = a;
    int mid = lo + (hi - lo) / 2;
    // nth_element over index range, permuting all parallel arrays: simplest
    // is an index sort then apply.
    std::vector<int> order(hi - lo);
    for (int i = 0; i < hi - lo; i++) order[i] = lo + i;
    std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
      return cent[x][a] < cent[y][a];
    });
    apply_order(lo, hi, order);
    return mid;
  }

  void apply_order(int lo, int hi, const std::vector<int> &order) {
    int n = hi - lo;
    std::vector<V3> a(n), b(n), c(n);
    std::vector<int64_t> p(n);
    for (int i = 0; i < n; i++) {
      a[i] = tmin[order[i]];
      b[i] = tmax[order[i]];
      c[i] = cent[order[i]];
      p[i] = perm[order[i]];
    }
    std::memcpy(&tmin[lo], a.data(), n * sizeof(V3));
    std::memcpy(&tmax[lo], b.data(), n * sizeof(V3));
    std::memcpy(&cent[lo], c.data(), n * sizeof(V3));
    std::memcpy(&perm[lo], p.data(), n * sizeof(int64_t));
  }

  int build_group(int lo, int hi) {
    int root = alloc(1);
    index[root] = lo;
    count[root] = hi - lo;
    set_bounds(root, lo, hi);
    struct Item {
      int node, lo, hi, depth;
    };
    std::vector<Item> stack{{root, lo, hi, 0}};
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      int n = it.hi - it.lo;
      stats_max_depth = std::max(stats_max_depth, it.depth);
      if (n <= max_leaf || it.depth >= MAX_DEPTH) {
        stats_max_leaf = std::max(stats_max_leaf, n);
        continue;
      }
      double cost;
      int a;
      float split;
      bool ok = find_split(it.lo, it.hi, cost, a, split);
      const V3 &mn = nmin[it.node];
      const V3 &mx = nmax[it.node];
      double ex = mx.x - mn.x, ey = mx.y - mn.y, ez = mx.z - mn.z;
      double no_split = (double)n * (ex * ey + ey * ez + ez * ex);
      int mid = -1;
      if (ok && cost < no_split) {
        mid = partition(it.lo, it.hi, a, split);
        if (mid == it.lo || mid == it.hi) mid = -1;
      }
      if (mid < 0) {
        if (n > max_leaf) {
          mid = median_split(it.lo, it.hi, a);
        } else {
          stats_max_leaf = std::max(stats_max_leaf, n);
          continue;
        }
      }
      int child = alloc(2);
      index[child] = it.lo;
      count[child] = mid - it.lo;
      index[child + 1] = mid;
      count[child + 1] = it.hi - mid;
      set_bounds(child, it.lo, mid);
      set_bounds(child + 1, mid, it.hi);
      index[it.node] = child;
      count[it.node] = 0;
      axis[it.node] = (int8_t)a;
      stack.push_back({child + 1, mid, it.hi, it.depth + 1});
      stack.push_back({child, it.lo, mid, it.depth + 1});
    }
    return root;
  }
};

void thread_links(const std::vector<int32_t> &index,
                  const std::vector<int32_t> &count,
                  const std::vector<int8_t> &axis,
                  const std::vector<int32_t> &roots, int32_t *hit,
                  int32_t *miss) {
  const int64_t n = (int64_t)index.size();
  for (int o = 0; o < 8; o++) {
    bool neg[3] = {(o & 1) != 0, (o & 2) != 0, (o & 4) != 0};
    int32_t *h = hit + o * n;
    int32_t *m = miss + o * n;
    struct Item {
      int32_t node, after;
    };
    std::vector<Item> stack;
    for (int32_t root : roots) {
      stack.push_back({root, SENTINEL});
      while (!stack.empty()) {
        Item it = stack.back();
        stack.pop_back();
        m[it.node] = it.after;
        if (count[it.node] == 0) {
          int32_t left = index[it.node];
          int32_t right = left + 1;
          int32_t near = neg[axis[it.node]] ? right : left;
          int32_t far = neg[axis[it.node]] ? left : right;
          h[it.node] = near;
          stack.push_back({far, it.after});
          stack.push_back({near, far});
        } else {
          h[it.node] = it.after;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// SBVH: binned SAH with *spatial splits* (Stich et al. 2009, "Spatial Splits
// in Bounding Volume Hierarchies").  Where plain SAH must put a big triangle
// wholly on one side — giving overlap-heavy trees on curtain/foliage content
// — the spatial split clips triangle *references* at a plane and emits a
// clipped reference to each side.  Leaves then address ranges of a REFERENCE
// array (perm maps refs -> original triangle ids, with duplicates); the
// downstream pipeline already copies triangle records per leaf row, so
// duplication costs only the extra rows.  Less node overlap means fewer
// node visits per ray walk.  No reference unsplitting (v1).
// ---------------------------------------------------------------------------

struct Ref {
  int32_t id;
  Box b;
};

inline Box box_intersect(const Box &a, const Box &b) {
  Box r;
  r.lo = vmax(a.lo, b.lo);
  r.hi = vmin(a.hi, b.hi);
  return r;
}
inline bool box_valid(const Box &b) {
  return b.lo.x <= b.hi.x && b.lo.y <= b.hi.y && b.lo.z <= b.hi.z;
}

struct Poly {
  V3 v[16];
  int n = 0;
};

// Sutherland-Hodgman clip against one axis plane.
static void clip_plane(Poly &p, int axis, float lim, bool keep_below) {
  Poly out;
  for (int i = 0; i < p.n; i++) {
    const V3 &a = p.v[i];
    const V3 &b = p.v[(i + 1) % p.n];
    float da = keep_below ? (lim - a[axis]) : (a[axis] - lim);
    float db = keep_below ? (lim - b[axis]) : (b[axis] - lim);
    bool ina = da >= 0, inb = db >= 0;
    if (ina) out.v[out.n++] = a;
    if (ina != inb && out.n < 16) {
      float t = da / (da - db);
      out.v[out.n++] = {a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
                        a.z + (b.z - a.z) * t};
    }
  }
  p = out;
}

// Tight box of triangle `id` clipped to [lo, hi] along `axis`.
static Box clipped_tri_box(const float *tv, int32_t id, int axis, float lo,
                           float hi) {
  const float *v = tv + (int64_t)id * 9;
  Poly p;
  p.n = 3;
  p.v[0] = {v[0], v[1], v[2]};
  p.v[1] = {v[3], v[4], v[5]};
  p.v[2] = {v[6], v[7], v[8]};
  clip_plane(p, axis, hi, true);
  clip_plane(p, axis, lo, false);
  Box b;
  for (int i = 0; i < p.n; i++) b.grow(p.v[i], p.v[i]);
  return b;
}

struct SBuilder {
  const float *tv;
  int max_leaf;
  double alpha;        // spatial split attempted when overlap/root > alpha
  int64_t ref_budget;  // duplication cap (total refs)
  int64_t refs_made = 0;

  std::vector<V3> nmin, nmax;
  std::vector<int32_t> index, count;
  std::vector<int8_t> axis;
  std::vector<int64_t> out_perm;  // leaf refs, in leaf-range order
  // NOTE: per-ref clipped boxes are NOT retained — no caller consumes
  // them (rt_build_sbvh exports nodes + out_perm only), and keeping them
  // cost O(refs) work+memory in the hot builder (round-3 advisor).
  int stats_max_leaf = 1;
  int stats_max_depth = 0;
  double root_area = 1.0;

  int alloc(int n) {
    int base = (int)index.size();
    nmin.resize(base + n);
    nmax.resize(base + n);
    index.resize(base + n, 0);
    count.resize(base + n, 0);
    axis.resize(base + n, 0);
    return base;
  }

  struct ObjSplit {
    double cost = std::numeric_limits<double>::infinity();
    int axis = -1;
    float pos = 0;
    double overlap = 0;  // surface area of L-box intersect R-box
  };

  ObjSplit find_object_split(const std::vector<Ref> &refs) const {
    ObjSplit best;
    for (int a = 0; a < 3; a++) {
      float cmin = 1e30f, cmax = -1e30f;
      for (const Ref &r : refs) {
        float c = 0.5f * (r.b.lo[a] + r.b.hi[a]);
        cmin = std::min(cmin, c);
        cmax = std::max(cmax, c);
      }
      if (cmin == cmax) continue;
      float scale = BINS / (cmax - cmin);
      Box bins[BINS];
      int64_t cnt[BINS] = {0};
      for (const Ref &r : refs) {
        float c = 0.5f * (r.b.lo[a] + r.b.hi[a]);
        int bi = std::min(BINS - 1, (int)std::floor((c - cmin) * scale));
        cnt[bi]++;
        bins[bi].grow(r.b.lo, r.b.hi);
      }
      double larea[BINS - 1], rarea[BINS - 1];
      Box lboxes[BINS - 1], rboxes[BINS - 1];
      int64_t lcnt[BINS - 1], rcnt[BINS - 1];
      Box lb, rb;
      int64_t ls = 0, rs = 0;
      for (int i = 0; i < BINS - 1; i++) {
        ls += cnt[i];
        lcnt[i] = ls;
        lb.grow(bins[i].lo, bins[i].hi);
        larea[i] = lb.area();
        lboxes[i] = lb;
        rs += cnt[BINS - 1 - i];
        rcnt[BINS - 2 - i] = rs;
        rb.grow(bins[BINS - 1 - i].lo, bins[BINS - 1 - i].hi);
        rarea[BINS - 2 - i] = rb.area();
        rboxes[BINS - 2 - i] = rb;
      }
      for (int i = 0; i < BINS - 1; i++) {
        if (lcnt[i] == 0 || rcnt[i] == 0) continue;
        double cost = lcnt[i] * larea[i] + rcnt[i] * rarea[i];
        if (cost < best.cost) {
          Box ov = box_intersect(lboxes[i], rboxes[i]);
          best = {cost, a, cmin + (cmax - cmin) / BINS * (i + 1),
                  box_valid(ov) ? ov.area() : 0.0};
        }
      }
    }
    return best;
  }

  struct SpatialSplit {
    double cost = std::numeric_limits<double>::infinity();
    int axis = -1;
    float pos = 0;
  };

  SpatialSplit find_spatial_split(const std::vector<Ref> &refs,
                                  const Box &node) const {
    SpatialSplit best;
    for (int a = 0; a < 3; a++) {
      float lo = node.lo[a], hi = node.hi[a];
      if (hi <= lo) continue;
      float scale = BINS / (hi - lo);
      float inv = (hi - lo) / BINS;
      Box bins[BINS];
      int64_t entry[BINS] = {0}, exit_[BINS] = {0};
      for (const Ref &r : refs) {
        int b0 = std::min(BINS - 1,
                          std::max(0, (int)((r.b.lo[a] - lo) * scale)));
        int b1 = std::min(BINS - 1,
                          std::max(0, (int)((r.b.hi[a] - lo) * scale)));
        if (b1 < b0) b1 = b0;
        entry[b0]++;
        exit_[b1]++;
        if (b0 == b1) {
          bins[b0].grow(r.b.lo, r.b.hi);
        } else {
          for (int bi = b0; bi <= b1; bi++) {
            Box cb = clipped_tri_box(tv, r.id, a, lo + bi * inv,
                                     bi == BINS - 1 ? hi : lo + (bi + 1) * inv);
            cb = box_intersect(cb, r.b);
            if (box_valid(cb)) bins[bi].grow(cb.lo, cb.hi);
          }
        }
      }
      double larea[BINS - 1], rarea[BINS - 1];
      int64_t lcnt[BINS - 1], rcnt[BINS - 1];
      Box lb, rb;
      int64_t ls = 0, rs = 0;
      for (int i = 0; i < BINS - 1; i++) {
        ls += entry[i];
        lcnt[i] = ls;
        lb.grow(bins[i].lo, bins[i].hi);
        larea[i] = lb.area();
        rs += exit_[BINS - 1 - i];
        rcnt[BINS - 2 - i] = rs;
        rb.grow(bins[BINS - 1 - i].lo, bins[BINS - 1 - i].hi);
        rarea[BINS - 2 - i] = rb.area();
      }
      for (int i = 0; i < BINS - 1; i++) {
        if (lcnt[i] == 0 || rcnt[i] == 0) continue;
        double cost = lcnt[i] * larea[i] + rcnt[i] * rarea[i];
        if (cost < best.cost) {
          best = {cost, a, lo + (i + 1) * inv};
        }
      }
    }
    return best;
  }

  void make_leaf(int node, std::vector<Ref> &refs) {
    index[node] = (int32_t)out_perm.size();
    count[node] = (int32_t)refs.size();
    stats_max_leaf = std::max<int>(stats_max_leaf, (int)refs.size());
    for (const Ref &r : refs) out_perm.push_back(r.id);
  }

  int build(std::vector<Ref> &&root_refs) {
    struct Item {
      int node, depth;
      std::vector<Ref> refs;
    };
    int root = alloc(1);
    {
      Box b;
      for (const Ref &r : root_refs) b.grow(r.b.lo, r.b.hi);
      nmin[root] = b.lo;
      nmax[root] = b.hi;
      root_area = std::max(b.area(), 1e-30);
    }
    refs_made = (int64_t)root_refs.size();
    std::vector<Item> stack;
    stack.push_back({root, 0, std::move(root_refs)});
    while (!stack.empty()) {
      Item it = std::move(stack.back());
      stack.pop_back();
      int n = (int)it.refs.size();
      stats_max_depth = std::max(stats_max_depth, it.depth);
      Box node{nmin[it.node], nmax[it.node]};
      if (n <= max_leaf || it.depth >= MAX_DEPTH) {
        make_leaf(it.node, it.refs);
        continue;
      }
      ObjSplit obj = find_object_split(it.refs);
      SpatialSplit spa;
      // Spatial split considered only when the object split's children
      // overlap significantly (the SBVH alpha heuristic) and the ref
      // budget allows duplication.
      if (obj.axis >= 0 && obj.overlap / root_area > alpha &&
          refs_made < ref_budget) {
        spa = find_spatial_split(it.refs, node);
      }
      double no_split = (double)n * node.area();
      bool use_spatial = spa.axis >= 0 && spa.cost < obj.cost;
      double best_cost = use_spatial ? spa.cost : obj.cost;

      std::vector<Ref> L, R;
      int split_axis = -1;
      if ((obj.axis >= 0 || use_spatial) && best_cost < no_split) {
        if (use_spatial) {
          split_axis = spa.axis;
          for (Ref &r : it.refs) {
            if (r.b.hi[spa.axis] <= spa.pos) {
              L.push_back(r);
            } else if (r.b.lo[spa.axis] >= spa.pos) {
              R.push_back(r);
            } else {
              Box bl = box_intersect(
                  clipped_tri_box(tv, r.id, spa.axis, -1e30f, spa.pos), r.b);
              Box br = box_intersect(
                  clipped_tri_box(tv, r.id, spa.axis, spa.pos, 1e30f), r.b);
              bool vl = box_valid(bl), vr = box_valid(br);
              // The budget is a HARD cap (the caller's perm buffer is
              // sized by it): once reached, straddlers stop duplicating
              // and go whole to the nearer side.
              if (vl && vr && refs_made >= ref_budget) {
                (0.5f * (r.b.lo[spa.axis] + r.b.hi[spa.axis]) < spa.pos ? L
                                                                        : R)
                    .push_back(r);
              } else if (vl && vr) {
                L.push_back({r.id, bl});
                R.push_back({r.id, br});
                refs_made++;
              } else if (vl) {
                L.push_back({r.id, bl});
              } else if (vr) {
                R.push_back({r.id, br});
              } else {
                // degenerate clip: keep original on the nearer side
                (0.5f * (r.b.lo[spa.axis] + r.b.hi[spa.axis]) < spa.pos ? L
                                                                        : R)
                    .push_back(r);
              }
            }
          }
        } else {
          split_axis = obj.axis;
          for (Ref &r : it.refs) {
            float c = 0.5f * (r.b.lo[obj.axis] + r.b.hi[obj.axis]);
            (c < obj.pos ? L : R).push_back(r);
          }
        }
        if (L.empty() || R.empty()) {
          L.clear();
          R.clear();
          split_axis = -1;
        }
      }
      if (split_axis < 0) {
        if (n > max_leaf) {
          // median fallback on the widest centroid axis
          V3 cmin{1e30f, 1e30f, 1e30f}, cmax{-1e30f, -1e30f, -1e30f};
          for (const Ref &r : it.refs) {
            V3 c{0.5f * (r.b.lo.x + r.b.hi.x), 0.5f * (r.b.lo.y + r.b.hi.y),
                 0.5f * (r.b.lo.z + r.b.hi.z)};
            cmin = vmin(cmin, c);
            cmax = vmax(cmax, c);
          }
          float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
          int a = 0;
          if (ext[1] > ext[a]) a = 1;
          if (ext[2] > ext[a]) a = 2;
          split_axis = a;
          std::stable_sort(it.refs.begin(), it.refs.end(),
                           [a](const Ref &x, const Ref &y) {
                             return 0.5f * (x.b.lo[a] + x.b.hi[a]) <
                                    0.5f * (y.b.lo[a] + y.b.hi[a]);
                           });
          size_t mid = it.refs.size() / 2;
          L.assign(it.refs.begin(), it.refs.begin() + mid);
          R.assign(it.refs.begin() + mid, it.refs.end());
        } else {
          make_leaf(it.node, it.refs);
          continue;
        }
      }
      int child = alloc(2);
      Box bl2, br2;
      for (const Ref &r : L) bl2.grow(r.b.lo, r.b.hi);
      for (const Ref &r : R) br2.grow(r.b.lo, r.b.hi);
      nmin[child] = bl2.lo;
      nmax[child] = bl2.hi;
      nmin[child + 1] = br2.lo;
      nmax[child + 1] = br2.hi;
      index[it.node] = child;
      count[it.node] = 0;
      axis[it.node] = (int8_t)split_axis;
      it.refs.clear();
      it.refs.shrink_to_fit();
      stack.push_back({child + 1, it.depth + 1, std::move(R)});
      stack.push_back({child, it.depth + 1, std::move(L)});
    }
    return root;
  }
};

}  // namespace

extern "C" {

// SBVH build over ONE triangle group (the flattened-scene production path).
// perm must be sized for ref_budget entries; node buffers for
// 2*ref_budget.  Returns node count (>0), or -1 on error; stats =
// [max_leaf_seen, max_depth, n_refs].
int64_t rt_build_sbvh(const float *tri_verts, int64_t n_tris,
                      int32_t max_leaf, double alpha, double budget_factor,
                      float *node_min, float *node_max, int32_t *node_index,
                      int32_t *node_count, int8_t *node_axis,
                      int32_t *hit_link, int32_t *miss_link, int64_t *perm,
                      int32_t *stats) {
  if (n_tris <= 0) return -1;
  SBuilder b;
  b.tv = tri_verts;
  b.max_leaf = std::max<int32_t>(max_leaf, SAH_LEAF);
  b.alpha = alpha;
  b.ref_budget = (int64_t)(budget_factor * (double)n_tris) + 8;
  std::vector<Ref> refs(n_tris);
  for (int64_t i = 0; i < n_tris; i++) {
    const float *v = tri_verts + i * 9;
    V3 p0{v[0], v[1], v[2]}, p1{v[3], v[4], v[5]}, p2{v[6], v[7], v[8]};
    Box bx;
    bx.grow(p0, p0);
    bx.grow(p1, p1);
    bx.grow(p2, p2);
    refs[i] = {(int32_t)i, bx};
  }
  int root = b.build(std::move(refs));
  int64_t n_nodes = (int64_t)b.index.size();
  int64_t n_refs = (int64_t)b.out_perm.size();
  for (int64_t i = 0; i < n_nodes; i++) {
    node_min[i * 3 + 0] = b.nmin[i].x;
    node_min[i * 3 + 1] = b.nmin[i].y;
    node_min[i * 3 + 2] = b.nmin[i].z;
    node_max[i * 3 + 0] = b.nmax[i].x;
    node_max[i * 3 + 1] = b.nmax[i].y;
    node_max[i * 3 + 2] = b.nmax[i].z;
  }
  std::memcpy(node_index, b.index.data(), n_nodes * sizeof(int32_t));
  std::memcpy(node_count, b.count.data(), n_nodes * sizeof(int32_t));
  std::memcpy(node_axis, b.axis.data(), n_nodes * sizeof(int8_t));
  std::memcpy(perm, b.out_perm.data(), n_refs * sizeof(int64_t));
  std::vector<int32_t> root_vec{root};
  thread_links(b.index, b.count, b.axis, root_vec, hit_link, miss_link);
  stats[0] = b.stats_max_leaf;
  stats[1] = b.stats_max_depth;
  stats[2] = (int32_t)n_refs;
  return n_nodes;
}

// Returns total node count, or -1 on error.  Output buffers must be sized
// for the worst case: nodes <= 2*n_tris (and >= 1 per group); links 8x that.
int64_t rt_build_bvh(const float *tri_verts,  // n_tris * 9 floats
                     int64_t n_tris,
                     const int64_t *group_offsets,  // n_groups+1 entries
                     int64_t n_groups, int32_t max_leaf,
                     // outputs
                     float *node_min, float *node_max, int32_t *node_index,
                     int32_t *node_count, int8_t *node_axis, int32_t *hit_link,
                     int32_t *miss_link, int64_t *perm, int32_t *roots,
                     int32_t *stats /* [max_leaf_seen, max_depth] */) {
  Builder b;
  b.max_leaf = std::max<int32_t>(max_leaf, SAH_LEAF);
  b.tmin.resize(n_tris);
  b.tmax.resize(n_tris);
  b.cent.resize(n_tris);
  b.perm.resize(n_tris);
  for (int64_t i = 0; i < n_tris; i++) {
    const float *v = tri_verts + i * 9;
    V3 p0{v[0], v[1], v[2]}, p1{v[3], v[4], v[5]}, p2{v[6], v[7], v[8]};
    b.tmin[i] = vmin(p0, vmin(p1, p2));
    b.tmax[i] = vmax(p0, vmax(p1, p2));
    b.cent[i] = {(p0.x + p1.x + p2.x) / 3.f, (p0.y + p1.y + p2.y) / 3.f,
                 (p0.z + p1.z + p2.z) / 3.f};
    b.perm[i] = i;
  }
  std::vector<int32_t> root_vec;
  for (int64_t g = 0; g < n_groups; g++) {
    int lo = (int)group_offsets[g];
    int hi = (int)group_offsets[g + 1];
    if (hi <= lo) return -1;
    root_vec.push_back(b.build_group(lo, hi));
  }
  int64_t n_nodes = (int64_t)b.index.size();
  for (int64_t i = 0; i < n_nodes; i++) {
    node_min[i * 3 + 0] = b.nmin[i].x;
    node_min[i * 3 + 1] = b.nmin[i].y;
    node_min[i * 3 + 2] = b.nmin[i].z;
    node_max[i * 3 + 0] = b.nmax[i].x;
    node_max[i * 3 + 1] = b.nmax[i].y;
    node_max[i * 3 + 2] = b.nmax[i].z;
  }
  std::memcpy(node_index, b.index.data(), n_nodes * sizeof(int32_t));
  std::memcpy(node_count, b.count.data(), n_nodes * sizeof(int32_t));
  std::memcpy(node_axis, b.axis.data(), n_nodes * sizeof(int8_t));
  std::memcpy(perm, b.perm.data(), n_tris * sizeof(int64_t));
  for (size_t i = 0; i < root_vec.size(); i++) roots[i] = root_vec[i];
  thread_links(b.index, b.count, b.axis, root_vec, hit_link, miss_link);
  stats[0] = b.stats_max_leaf;
  stats[1] = b.stats_max_depth;
  return n_nodes;
}
}
