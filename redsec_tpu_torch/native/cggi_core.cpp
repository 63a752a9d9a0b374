// cggi_core.cpp — native CGGI/TFHE evaluation core (CPU backend + oracle).
//
// A from-scratch C++ implementation of the same pipeline as
// redsec_tpu_torch/crypto/bootstrap.py: mod-switch, blind rotation (TGSW
// external products over an exact CRT-NTT), sample extraction and key
// switching.  Role: an independent native oracle for the CUDA path and a CPU
// serving backend (OpenMP-parallel batched bootstraps), in the position of the
// reference's TFHE/SPQLIOS CPU engine (lib/BinOps_enc.cpp:182-192 + OpenMP
// loops in lib/BinFunc.cpp).
//
// Arithmetic: torus32 = int32 two's complement; polynomial products exact via
// negacyclic NTT mod 15/16-bit primes (int64 arithmetic, no floating point),
// 8-bit limb split of the key, CRT recombination mod 2^32 — the same number
// theory as crypto/ntt.py, independently implemented.
//
// Build (native/__init__.py does it into build/native/):
//   g++ -O3 -march=native -fopenmp -shared -fPIC cggi_core.cpp -o libcggi_core.so

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef int32_t Torus32;
typedef uint32_t u32;
typedef int64_t i64;
typedef uint64_t u64;

namespace {

struct Params {
    int32_t n;          // LWE dimension
    int32_t N;          // polynomial degree
    int32_t l;          // TGSW levels
    int32_t bg_bit;     // TGSW base bits
    int32_t ks_t;       // keyswitch levels
    int32_t ks_basebit; // keyswitch base bits
};

// ---- modular helpers (int64, exact) ----------------------------------------

static i64 pow_mod(i64 b, i64 e, i64 m) {
    i64 r = 1;
    b %= m;
    while (e > 0) {
        if (e & 1) r = r * b % m;
        b = b * b % m;
        e >>= 1;
    }
    return r;
}

// Barrett reduction, valid for any odd p < 2^32 and x < 2^64:
// m = floor((2^64 - 1) / p) (== floor(2^64 / p) for p not a power of two),
// q = (x * m) >> 64 underestimates x/p by at most 2.
struct Barrett {
    i64 p;
    u64 m;
    void init(i64 prime) { p = prime; m = (~u64(0)) / u64(prime); }
    inline i64 mul(i64 a, i64 b) const {  // a, b in [0, p)
        return reduce64(u64(a) * u64(b));
    }
    inline i64 reduce64(u64 x) const {  // any x < 2^64
        u64 q = (u64)(((__uint128_t)x * m) >> 64);
        i64 r = i64(x - q * u64(p));
        while (r >= p) r -= p;
        return r;
    }
};

static bool is_primitive_root(i64 g, i64 p, const std::vector<i64>& factors) {
    for (i64 q : factors)
        if (pow_mod(g, (p - 1) / q, p) == 1) return false;
    return true;
}

static i64 primitive_root(i64 p) {
    std::vector<i64> factors;
    i64 m = p - 1;
    for (i64 d = 2; d * d <= m; ++d) {
        if (m % d == 0) {
            factors.push_back(d);
            while (m % d == 0) m /= d;
        }
    }
    if (m > 1) factors.push_back(m);
    for (i64 g = 2; g < p; ++g)
        if (is_primitive_root(g, p, factors)) return g;
    return -1;
}

// ---- per-prime negacyclic NTT (DIF fwd / DIT inv, matching ntt.py) ---------

struct NttPrime {
    i64 p;
    Barrett br;
    int N;
    std::vector<i64> twist, untwist;        // psi^j, psi^-j / N
    std::vector<std::vector<i64>> fwd_tabs; // per stage
    std::vector<std::vector<i64>> inv_tabs;

    void init(i64 prime, int n_poly) {
        p = prime;
        br.init(prime);
        N = n_poly;
        i64 g = primitive_root(p);
        i64 psi = pow_mod(g, (p - 1) / (2 * N), p);
        i64 w = psi * psi % p;
        twist.resize(N);
        untwist.resize(N);
        i64 ninv = pow_mod(N, p - 2, p);
        for (int j = 0; j < N; ++j) {
            twist[j] = pow_mod(psi, j, p);
            untwist[j] = pow_mod(psi, (2 * N - j) % (2 * N), p) * ninv % p;
        }
        int stages = 0;
        while ((1 << stages) < N) ++stages;
        fwd_tabs.resize(stages);
        inv_tabs.resize(stages);
        for (int s = 0; s < stages; ++s) {
            int h = N >> (s + 1);
            i64 wf = pow_mod(w, i64(1) << s, p);
            fwd_tabs[s].resize(h);
            for (int i = 0; i < h; ++i) fwd_tabs[s][i] = pow_mod(wf, i, p);
            int hh = 1 << s;
            i64 wi = pow_mod(pow_mod(w, N >> (s + 1), p), p - 2, p);
            inv_tabs[s].resize(hh);
            for (int i = 0; i < hh; ++i) inv_tabs[s][i] = pow_mod(wi, i, p);
        }
    }

    void fwd(i64* a) const {  // in place, natural -> bit-reversed
        for (int j = 0; j < N; ++j) a[j] = br.mul((a[j] % p + p) % p, twist[j]);
        int stages = (int)fwd_tabs.size();
        std::vector<i64> tmp(N);
        for (int s = 0; s < stages; ++s) {
            int m = 1 << s, h = N >> (s + 1);
            for (int g = 0; g < m; ++g) {
                const i64* x = a + g * 2 * h;
                i64* o = tmp.data() + g * 2 * h;
                const std::vector<i64>& wt = fwd_tabs[s];
                for (int i = 0; i < h; ++i) {
                    i64 u = x[i], v = x[i + h];
                    i64 su = u + v;
                    if (su >= p) su -= p;
                    o[i] = su;
                    o[i + h] = br.mul(u - v + p >= p ? u - v : u - v + p, wt[i]);
                }
            }
            std::memcpy(a, tmp.data(), N * sizeof(i64));
        }
    }

    void inv(i64* a) const {  // in place, bit-reversed -> natural
        int stages = (int)inv_tabs.size();
        std::vector<i64> tmp(N);
        for (int s = 0; s < stages; ++s) {
            int m = N >> (s + 1), h = 1 << s;
            for (int g = 0; g < m; ++g) {
                const i64* x = a + g * 2 * h;
                i64* o = tmp.data() + g * 2 * h;
                const std::vector<i64>& wt = inv_tabs[s];
                for (int i = 0; i < h; ++i) {
                    i64 t = br.mul(x[i + h], wt[i]);
                    i64 su = x[i] + t;
                    if (su >= p) su -= p;
                    o[i] = su;
                    i64 d = x[i] - t;
                    o[i + h] = d < 0 ? d + p : d;
                }
            }
            std::memcpy(a, tmp.data(), N * sizeof(i64));
        }
        for (int j = 0; j < N; ++j) a[j] = br.mul(a[j], untwist[j]);
    }
};

struct Engine {
    Params prm;
    std::vector<NttPrime> primes;
    // BK in NTT domain: [n][rows][2][limbs=4][nprimes][N] as i64 (8-bit limbs)
    std::vector<i64> bk_ntt;
    // KSK raw (multiply-form): [N][t][n+1]
    std::vector<Torus32> ksk;
    u32 dec_offset;
    int rows;

    size_t bk_idx(int i, int r, int u, int limb, int pi) const {
        return ((((size_t)i * rows + r) * 2 + u) * 4 + limb) * primes.size() + pi;
    }
};

static i64 crt2_to_torus(i64 c0, i64 c1, i64 p0, i64 p1) {
    // value v with v mod p0 = c0, v mod p1 = c1, |v| < p0*p1/2 -> v mod 2^32
    i64 inv = pow_mod(p0 % p1, p1 - 2, p1);
    i64 t = (c1 - c0 % p1 + p1) % p1 * inv % p1;
    i64 v = c0 + p0 * t;  // in [0, p0*p1)
    i64 P = p0 * p1;
    if (v >= P / 2) v -= P;
    return v;
}

}  // namespace

extern "C" {

// Create an evaluation engine from raw key material.
//  bk:  int32 [n][rows][2][N]   (TGSW bootstrapping key, coefficient domain)
//  ksk: int32 [N][t][n+1]  (multiply-form, v=1 plane)
void* cggi_engine_new(const int32_t* p_arr, const Torus32* bk, const Torus32* ksk) {
    Engine* e = new Engine();
    e->prm.n = p_arr[0];
    e->prm.N = p_arr[1];
    e->prm.l = p_arr[2];
    e->prm.bg_bit = p_arr[3];
    e->prm.ks_t = p_arr[4];
    e->prm.ks_basebit = p_arr[5];
    const Params& P = e->prm;
    e->rows = 2 * P.l;

    // prime selection: cover the exact row-accumulated convolution bound with
    // primes = 1 mod 2N. The small entries (< 2^16) serve N <= 2048 exactly
    // like crypto/ntt.py; the larger ones (int64-safe with the 64-bit
    // Barrett) extend the engine to the medium/large sets (N = 4096/8192,
    // client/gen_secure_keyset.cpp:9-45) that the int32 device NTT cannot
    // reach (the device uses the conv-schoolbook path there instead).
    static const i64 cand[8] = {12289, 18433, 40961, 65537, 114689,
                                147457, 163841, 270337};
    i64 bound = 2LL * e->rows * P.N * (1LL << (P.bg_bit - 1)) * 255LL;
    i64 prod = 1;
    for (i64 c : cand) {
        if ((c - 1) % (2 * P.N) != 0) continue;
        e->primes.emplace_back();
        e->primes.back().init(c, P.N);
        prod *= c;
        if (prod > bound) break;
    }

    // decomposition offset
    u32 off = 0;
    for (int j = 1; j <= P.l; ++j) off += (u32(1) << (P.bg_bit - 1)) << (32 - j * P.bg_bit);
    e->dec_offset = off;

    // transform BK
    int np = (int)e->primes.size();
    e->bk_ntt.assign((size_t)P.n * e->rows * 2 * 4 * np * P.N, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < P.n; ++i) {
        std::vector<i64> lbuf(P.N);
        for (int r = 0; r < e->rows; ++r)
            for (int u = 0; u < 2; ++u) {
                const Torus32* poly = bk + (((size_t)i * e->rows + r) * 2 + u) * P.N;
                for (int limb = 0; limb < 4; ++limb) {
                    for (int pi = 0; pi < np; ++pi) {
                        for (int j = 0; j < P.N; ++j)
                            lbuf[j] = (u32(poly[j]) >> (8 * limb)) & 0xFF;
                        e->primes[pi].fwd(lbuf.data());
                        i64* dst = &e->bk_ntt[e->bk_idx(i, r, u, limb, pi) * P.N];
                        std::memcpy(dst, lbuf.data(), P.N * sizeof(i64));
                    }
                }
            }
    }

    size_t ksk_len = (size_t)P.N * P.ks_t * (P.n + 1);
    e->ksk.assign(ksk, ksk + ksk_len);
    return e;
}

void cggi_engine_free(void* h) { delete (Engine*)h; }

// Bootstrap a batch: in [B][n+1], testvect [N] (shared), out [B][n+1].
void cggi_bootstrap_batch(void* h, const Torus32* in, const Torus32* testvect,
                          Torus32* out, int batch) {
    Engine* e = (Engine*)h;
    const Params& P = e->prm;
    const int N = P.N, n = P.n, l = P.l, rows = e->rows;
    const int np = (int)e->primes.size();
    const int two_n = 2 * N;
    const int ms_shift = 32 - (32 - __builtin_clz(two_n) - 1);
    const u32 half = u32(1) << (ms_shift - 1);
    const u32 mask2n = two_n - 1;
    const int base = 1 << P.ks_basebit;
    // rounding offset = half the KS truncation step; full-precision KS
    // (basebit*t >= 32: the repaired medium_v2/large_v2 recipes) truncates
    // nothing, so the offset is zero (a negative shift would be UB)
    const int ks_bits = P.ks_basebit * P.ks_t;
    const u32 prec = ks_bits < 32 ? (u32(1) << (32 - 1 - ks_bits)) : 0;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int b = 0; b < batch; ++b) {
        const Torus32* ct = in + (size_t)b * (n + 1);
        // mod switch
        std::vector<int> abar(n);
        for (int i = 0; i < n; ++i) abar[i] = ((u32(ct[i]) + half) >> ms_shift) & mask2n;
        int bbar = ((u32(ct[n]) + half) >> ms_shift) & mask2n;

        // acc = (0, X^{-bbar} * tv)
        std::vector<Torus32> acc(2 * N, 0);
        {
            int t = (two_n - bbar) & mask2n;
            for (int j = 0; j < N; ++j) {
                int src = j - t;
                int sm = ((src % two_n) + two_n) % two_n;
                Torus32 v = (sm < N) ? testvect[sm] : -testvect[sm - N];
                acc[N + j] = v;
            }
        }

        std::vector<Torus32> diff(2 * N);
        std::vector<i64> dig_ntt(N), conv(N);
        std::vector<i64> acc_sum(2 * 4 * np * N);  // [u][limb][pi][N]

        for (int i = 0; i < n; ++i) {
            int t = abar[i];
            if (t == 0) continue;  // X^0 - 1 = 0: CMUX is a no-op
            // diff = X^t * acc - acc
            for (int u = 0; u < 2; ++u) {
                const Torus32* a = &acc[u * N];
                Torus32* d = &diff[u * N];
                for (int j = 0; j < N; ++j) {
                    int src = j - t;
                    int sm = ((src % two_n) + two_n) % two_n;
                    Torus32 v = (sm < N) ? a[sm] : -a[sm - N];
                    d[j] = v - a[j];
                }
            }
            std::fill(acc_sum.begin(), acc_sum.end(), 0);
            // decompose + NTT + accumulate against BK row
            for (int u_in = 0; u_in < 2; ++u_in) {
                for (int j = 0; j < l; ++j) {
                    int r = u_in * l + j;
                    int shift = 32 - (j + 1) * P.bg_bit;
                    for (int pi = 0; pi < np; ++pi) {
                        i64 p = e->primes[pi].p;
                        for (int k = 0; k < N; ++k) {
                            u32 tmp = u32(diff[u_in * N + k]) + e->dec_offset;
                            i64 d = (i64)((tmp >> shift) & ((1u << P.bg_bit) - 1)) -
                                    (1 << (P.bg_bit - 1));
                            dig_ntt[k] = d < 0 ? d + p : d;
                        }
                        e->primes[pi].fwd(dig_ntt.data());
                        for (int u_out = 0; u_out < 2; ++u_out)
                            for (int limb = 0; limb < 4; ++limb) {
                                const i64* bkrow =
                                    &e->bk_ntt[e->bk_idx(i, r, u_out, limb, pi) * N];
                                i64* dst = &acc_sum[(((size_t)u_out * 4 + limb) * np + pi) * N];
                                for (int k = 0; k < N; ++k)
                                    dst[k] += dig_ntt[k] * bkrow[k];  // < 20 * p^2 < 2^40: lazy
                            }
                    }
                }
            }
            // inverse NTT + CRT + add to acc
            for (int u_out = 0; u_out < 2; ++u_out) {
                for (int limb = 0; limb < 4; ++limb) {
                    std::vector<std::vector<i64>> res(np, std::vector<i64>(N));
                    for (int pi = 0; pi < np; ++pi) {
                        i64* src = &acc_sum[(((size_t)u_out * 4 + limb) * np + pi) * N];
                        const Barrett& br = e->primes[pi].br;
                        for (int k = 0; k < N; ++k) res[pi][k] = br.reduce64((u64)src[k]);
                        e->primes[pi].inv(res[pi].data());
                    }
                    for (int k = 0; k < N; ++k) {
                        i64 v;
                        if (np == 2)
                            v = crt2_to_torus(res[0][k], res[1][k], e->primes[0].p,
                                              e->primes[1].p);
                        else {
                            // general CRT (3 primes): garner
                            i64 p0 = e->primes[0].p, p1 = e->primes[1].p,
                                p2 = e->primes[2].p;
                            i64 t1 = (res[1][k] - res[0][k] % p1 + p1) % p1 *
                                     pow_mod(p0 % p1, p1 - 2, p1) % p1;
                            i64 x01 = res[0][k] + p0 * t1;
                            i64 t2 = (res[2][k] - x01 % p2 + p2) % p2 *
                                     pow_mod(p0 * p1 % p2, p2 - 2, p2) % p2;
                            __int128 full = (__int128)x01 + (__int128)p0 * p1 * t2;
                            __int128 P128 = (__int128)p0 * p1 * p2;
                            if (full >= P128 / 2) full -= P128;
                            v = (i64)(full & 0xFFFFFFFF);
                        }
                        acc[u_out * N + k] =
                            Torus32(u32(acc[u_out * N + k]) + (u32)((u64)v << (8 * limb)));
                    }
                }
            }
        }

        // sample extract
        std::vector<Torus32> a_ext(N);
        a_ext[0] = acc[0];
        for (int i = 1; i < N; ++i) a_ext[i] = -acc[N - i];
        Torus32 b_ext = acc[N];

        // key switch
        Torus32* o = out + (size_t)b * (n + 1);
        std::memset(o, 0, (n + 1) * sizeof(Torus32));
        o[n] = b_ext;
        for (int i = 0; i < N; ++i) {
            u32 ai = u32(a_ext[i]) + prec;
            for (int j = 0; j < P.ks_t; ++j) {
                Torus32 d = Torus32((ai >> (32 - (j + 1) * P.ks_basebit)) & (base - 1));
                if (d == 0) continue;
                const Torus32* row = &e->ksk[((size_t)i * P.ks_t + j) * (n + 1)];
                for (int k = 0; k <= n; ++k)
                    o[k] = Torus32(u32(o[k]) - u32(d) * u32(row[k]));
            }
        }
    }
}

int cggi_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
