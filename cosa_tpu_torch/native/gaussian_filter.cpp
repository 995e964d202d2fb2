// High-dimensional Gaussian transforms: exact O(N^2) and permutohedral
// lattice, C++/OpenMP.
//
// Own implementation of the lattice algorithm (Adams, Baek & Davis,
// Eurographics 2010) mirroring the JAX package's ops/permutohedral.py; used as a
// host-side oracle. In the PyTorch port it backs the energy-convention
// calibration (objectives/energy.py::resolve_energy_convention), which
// holds the RFF surrogate to the lattice's energy scale. The role matches
// the reference's utils/bilateralfilter C++/SWIG extension.
//
// Build: cosa_tpu_torch/native/build.py (ctypes, plain C ABI).

#include <cmath>
#include <cstdint>
#include <cstring>

#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// exact transform: out[i] = sum_j exp(-||f_i-f_j||^2/2) v[j]
void exact_rows(const float* feats, const float* vals, float* out, int n,
                int d, int k) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    float* acc = out + (size_t)i * k;
    std::memset(acc, 0, sizeof(float) * k);
    const float* fi = feats + (size_t)i * d;
    for (int j = 0; j < n; ++j) {
      const float* fj = feats + (size_t)j * d;
      float d2 = 0.f;
      for (int a = 0; a < d; ++a) {
        float t = fi[a] - fj[a];
        d2 += t * t;
      }
      float w = std::exp(-0.5f * d2);
      const float* vj = vals + (size_t)j * k;
      for (int c = 0; c < k; ++c) acc[c] += w * vj[c];
    }
  }
}

// Open-addressing hash table over flat int16 keys. The first version of
// this file used std::unordered_map<std::vector<int16_t>, int>: every probe
// hashed a heap vector and every insert copied one, which made the lattice
// ~50x slower than the splat/blur/slice arithmetic it feeds (6.6 s for a
// 187k-pixel K=21 filter). Linear probing over contiguous key storage and a
// precomputed blur-neighbor table bring it back to memory speed.
class FlatTable {
 public:
  FlatTable(int d, size_t expect) : d_(d) {
    cap_ = 64;
    while (cap_ < expect * 2) cap_ <<= 1;
    mask_ = cap_ - 1;
    slots_.assign(cap_, -1);
    keys_.reserve(expect * (size_t)d);
  }
  inline size_t hashk(const int16_t* k) const {
    size_t h = 14695981039346656037ull;
    for (int i = 0; i < d_; ++i) {
      h ^= (size_t)(uint16_t)k[i];
      h *= 1099511628211ull;
    }
    return h;
  }
  inline bool eq(const int16_t* a, const int16_t* b) const {
    for (int i = 0; i < d_; ++i)
      if (a[i] != b[i]) return false;
    return true;
  }
  int find_or_insert(const int16_t* k) {
    size_t s = hashk(k) & mask_;
    while (true) {
      int e = slots_[s];
      if (e < 0) {
        int idx = (int)(keys_.size() / (size_t)d_);
        slots_[s] = idx;
        keys_.insert(keys_.end(), k, k + d_);
        return idx;
      }
      if (eq(keys_.data() + (size_t)e * d_, k)) return e;
      s = (s + 1) & mask_;
    }
  }
  int find(const int16_t* k) const {
    size_t s = hashk(k) & mask_;
    while (true) {
      int e = slots_[s];
      if (e < 0) return -1;
      if (eq(keys_.data() + (size_t)e * d_, k)) return e;
      s = (s + 1) & mask_;
    }
  }
  int size() const { return (int)(keys_.size() / (size_t)d_); }
  const int16_t* key(int i) const { return keys_.data() + (size_t)i * d_; }

 private:
  int d_;
  size_t cap_, mask_;
  std::vector<int> slots_;
  std::vector<int16_t> keys_;
};

class Lattice {
 public:
  Lattice(int n, int d)
      : n_(n), d_(d), dp1_(d + 1), table_(d, (size_t)n * (d + 1)) {
    offsets_.assign((size_t)n * dp1_, -1);
    bary_.assign((size_t)n * dp1_, 0.f);
  }

  // build simplex memberships for all points
  void build(const float* feats) {
    const int d = d_, dp1 = dp1_;
    std::vector<float> scale(d);
    const float inv_std = std::sqrt(2.f / 3.f) * dp1;
    for (int i = 0; i < d; ++i)
      scale[i] = inv_std / std::sqrt((float)(i + 1) * (i + 2));

    std::vector<float> elevated(dp1), bary(dp1 + 1);
    std::vector<int> rem0(dp1), rank(dp1);
    std::vector<int16_t> key(d);

    for (int p = 0; p < n_; ++p) {
      const float* f = feats + (size_t)p * d;
      // hyperplane embedding via the d-step recurrence
      float sm = 0.f;
      for (int j = d; j > 0; --j) {
        float cf = f[j - 1] * scale[j - 1];
        elevated[j] = sm - j * cf;
        sm += cf;
      }
      elevated[0] = sm;

      // nearest zero-colored lattice point
      int sum = 0;
      for (int i = 0; i < dp1; ++i) {
        float v = elevated[i] / dp1;
        int up = (int)std::ceil(v) * dp1;
        int down = (int)std::floor(v) * dp1;
        rem0[i] = (up - elevated[i] < elevated[i] - down) ? up : down;
        sum += rem0[i] / dp1;
      }

      // rank = descending order of residuals (ties by index)
      for (int i = 0; i < dp1; ++i) rank[i] = 0;
      for (int i = 0; i < d; ++i)
        for (int j = i + 1; j < dp1; ++j) {
          if (elevated[i] - rem0[i] < elevated[j] - rem0[j])
            ++rank[i];
          else
            ++rank[j];
        }
      // fixup so the simplex sums to zero
      for (int i = 0; i < dp1; ++i) {
        rank[i] += sum;
        if (rank[i] < 0) {
          rank[i] += dp1;
          rem0[i] += dp1;
        } else if (rank[i] > d) {
          rank[i] -= dp1;
          rem0[i] -= dp1;
        }
      }

      // barycentric coordinates
      std::fill(bary.begin(), bary.end(), 0.f);
      for (int i = 0; i < dp1; ++i) {
        float v = (elevated[i] - rem0[i]) / dp1;
        bary[d - rank[i]] += v;
        bary[dp1 - rank[i]] -= v;
      }
      bary[0] += 1.f + bary[dp1];

      // register the d+1 simplex corners
      for (int r = 0; r < dp1; ++r) {
        for (int i = 0; i < d; ++i)
          key[i] =
              (int16_t)(rem0[i] + (rank[i] >= dp1 - r ? r - dp1 : r));
        int idx = table_.find_or_insert(key.data());
        offsets_[(size_t)p * dp1 + r] = idx;
        bary_[(size_t)p * dp1 + r] = bary[r];
      }
    }

    // blur-neighbor table: (m, d+1, 2) entry indices, built once so the
    // d+1 blur passes are pure array walks (no hashing in the hot loop)
    const int m = table_.size();
    nbr_.assign((size_t)m * dp1 * 2, -1);
#pragma omp parallel for schedule(static)
    for (int i = 0; i < m; ++i) {
      std::vector<int16_t> nkey(d);
      const int16_t* k = table_.key(i);
      for (int a = 0; a <= d; ++a)
        for (int s = 0; s < 2; ++s) {
          const int sgn = s == 0 ? -1 : 1;
          for (int t = 0; t < d; ++t)
            nkey[t] = (int16_t)(k[t] + sgn * (t == a ? -d : 1));
          nbr_[((size_t)i * dp1 + a) * 2 + s] = table_.find(nkey.data());
        }
    }
  }

  void filter(const float* vals, float* out, int k) {
    const int m = (int)table_.size();
    const int d = d_, dp1 = dp1_;
    std::vector<float> lattice((size_t)m * k, 0.f);

    // splat
    for (int p = 0; p < n_; ++p)
      for (int r = 0; r < dp1; ++r) {
        int idx = offsets_[(size_t)p * dp1 + r];
        float w = bary_[(size_t)p * dp1 + r];
        const float* v = vals + (size_t)p * k;
        float* l = lattice.data() + (size_t)idx * k;
        for (int c = 0; c < k; ++c) l[c] += w * v[c];
      }

    // blur along each lattice direction with a [1/2, 1, 1/2] stencil,
    // walking the precomputed neighbor table
    std::vector<float> next((size_t)m * k);
    for (int a = 0; a <= d; ++a) {
#pragma omp parallel for schedule(static)
      for (int i = 0; i < m; ++i) {
        float* dst = next.data() + (size_t)i * k;
        const float* src = lattice.data() + (size_t)i * k;
        for (int c = 0; c < k; ++c) dst[c] = src[c];
        const int* nb = nbr_.data() + ((size_t)i * dp1 + a) * 2;
        for (int s = 0; s < 2; ++s) {
          if (nb[s] >= 0) {
            const float* nv = lattice.data() + (size_t)nb[s] * k;
            for (int c = 0; c < k; ++c) dst[c] += 0.5f * nv[c];
          }
        }
      }
      lattice.swap(next);
    }

    // slice
    const float alpha = 1.f / (1.f + std::pow(2.f, -(float)d));
    std::memset(out, 0, sizeof(float) * (size_t)n_ * k);
#pragma omp parallel for schedule(static)
    for (int p = 0; p < n_; ++p) {
      float* o = out + (size_t)p * k;
      for (int r = 0; r < dp1; ++r) {
        int idx = offsets_[(size_t)p * dp1 + r];
        float w = bary_[(size_t)p * dp1 + r] * alpha;
        const float* l = lattice.data() + (size_t)idx * k;
        for (int c = 0; c < k; ++c) o[c] += w * l[c];
      }
    }
  }

 private:
  int n_, d_, dp1_;
  FlatTable table_;
  std::vector<int> nbr_;
  std::vector<int> offsets_;
  std::vector<float> bary_;
};

}  // namespace

extern "C" {

// out[i] = sum_j exp(-0.5||f_i - f_j||^2) v[j]; feats (n, d), vals (n, k)
void cosa_exact_gaussian(const float* feats, const float* vals, float* out,
                         int n, int d, int k) {
  exact_rows(feats, vals, out, n, d, k);
}

// permutohedral approximation (same normalization convention as the JAX
// lattice in ops/permutohedral.py)
void cosa_lattice_gaussian(const float* feats, const float* vals, float* out,
                           int n, int d, int k) {
  Lattice lat(n, d);
  lat.build(feats);
  lat.filter(vals, out, k);
}

// batched lattice over independent images (OpenMP across the batch, like
// the role the reference's bilateralfilter_batch plays)
void cosa_lattice_gaussian_batch(const float* feats, const float* vals,
                                 float* out, int b, int n, int d, int k) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < b; ++i) {
    Lattice lat(n, d);
    lat.build(feats + (size_t)i * n * d);
    lat.filter(vals + (size_t)i * n * k, out + (size_t)i * n * k, k);
  }
}
}
