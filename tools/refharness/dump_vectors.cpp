// Test-vector dump harness.
//
// Links against the READ-ONLY reference headers at /root/reference/include
// (not copied into this repo). Produces tests/golden/vectors.json with
// deterministic input/output pairs for every keyed/deterministic component
// of the reference scheme, so the JAX reimplementation can be
// validated bit-exactly without ever running the C++ code in CI.
//
// All inputs are synthetic and fixed (splitmix64-derived), so this dump is
// reproducible.
#include <pvac/pvac.hpp>
#include <cstdio>
#include <cstdarg>
#include <cstring>
#include <string>
#include <vector>

using namespace pvac;

static uint64_t sm64_state;
static uint64_t sm64() {
    uint64_t z = (sm64_state += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
}

static FILE* out;
static bool first_in_scope = true;

static void emit(const char* fmt, ...) {
    va_list ap; va_start(ap, fmt); vfprintf(out, fmt, ap); va_end(ap);
}
static std::string hexbytes(const uint8_t* p, size_t n) {
    static const char* d = "0123456789abcdef";
    std::string s; s.reserve(2*n);
    for (size_t i = 0; i < n; i++) { s += d[p[i]>>4]; s += d[p[i]&15]; }
    return s;
}
static std::string u64s_json(const std::vector<uint64_t>& v) {
    std::string s = "[";
    char buf[32];
    for (size_t i = 0; i < v.size(); i++) {
        snprintf(buf, sizeof buf, "\"%llu\"", (unsigned long long)v[i]);
        if (i) s += ",";
        s += buf;
    }
    s += "]";
    return s;
}
static std::string ints_json(const std::vector<int>& v) {
    std::string s = "[";
    char buf[16];
    for (size_t i = 0; i < v.size(); i++) {
        snprintf(buf, sizeof buf, "%d", v[i]);
        if (i) s += ",";
        s += buf;
    }
    s += "]";
    return s;
}

static Params small_params() {
    Params p;
    p.m_bits = 512;
    p.n_bits = 1024;
    p.h_col_wt = 48;
    p.x_col_wt = 32;
    p.err_wt = 32;
    p.lpn_n = 256;
    p.lpn_t = 1024;
    return p;
}

int main() {
    out = fopen("tests/golden/vectors.json", "w");
    if (!out) { fprintf(stderr, "cannot open output\n"); return 1; }
    emit("{\n");

    // ---------------- SHA-256 ----------------
    {
        const char* msgs[] = {"", "abc", "pvac.dom.x_seed",
            "The quick brown fox jumps over the lazy dog"};
        emit("\"sha256\": [");
        for (int i = 0; i < 4; i++) {
            uint8_t d[32];
            sha256_bytes(msgs[i], strlen(msgs[i]), d);
            emit("%s{\"msg\":\"%s\",\"digest\":\"%s\"}", i?",":"", msgs[i], hexbytes(d,32).c_str());
        }
        // long input crossing many blocks
        std::vector<uint8_t> big(1000);
        for (size_t i = 0; i < big.size(); i++) big[i] = (uint8_t)(i*7+3);
        uint8_t d[32]; sha256_bytes(big.data(), big.size(), d);
        emit(",{\"msg_pattern\":\"i*7+3 len=1000\",\"digest\":\"%s\"}", hexbytes(d,32).c_str());
        emit("],\n");
    }

    // ---------------- SHAKE256 / XofShake ----------------
    {
        XofShake x;
        x.init("pvac.test.label", {1ull, 2ull, 0xdeadbeefcafebabeull});
        std::vector<uint64_t> ws;
        for (int i = 0; i < 16; i++) ws.push_back(x.take_u64());
        std::vector<uint64_t> bs;
        for (int i = 0; i < 8; i++) bs.push_back(x.bounded(337));
        emit("\"xof_shake\": {\"label\":\"pvac.test.label\",\"seed\":[\"1\",\"2\",\"16045690984503098046\"],"
             "\"u64s\":%s,\"bounded337\":%s},\n", u64s_json(ws).c_str(), u64s_json(bs).c_str());
    }

    // ---------------- AES-256-CTR ----------------
    {
        emit("\"aes256_ctr\": [");
        for (int c = 0; c < 3; c++) {
            uint8_t key[32];
            sm64_state = 0x1111 * (c + 1);
            for (int i = 0; i < 32; i++) key[i] = (uint8_t)(sm64() & 0xFF);
            uint64_t nonce = sm64();
            AesCtr256 prg; prg.init(key, nonce);
            std::vector<uint64_t> stream(40);
            prg.fill_u64(stream.data(), stream.size());
            std::vector<uint64_t> bnd;
            for (int i = 0; i < 8; i++) bnd.push_back(prg.bounded(8));
            std::vector<uint64_t> more(5);
            prg.fill_u64(more.data(), more.size());
            emit("%s{\"key\":\"%s\",\"nonce\":\"%llu\",\"u64s\":%s,\"bounded8_after40\":%s,\"u64s_after\":%s}",
                 c?",":"", hexbytes(key,32).c_str(), (unsigned long long)nonce,
                 u64s_json(stream).c_str(), u64s_json(bnd).c_str(), u64s_json(more).c_str());
        }
        // FIPS-197-style: zero key, zero nonce
        uint8_t zk[32] = {0};
        AesCtr256 prg; prg.init(zk, 0);
        std::vector<uint64_t> z2(4); prg.fill_u64(z2.data(), 4);
        emit(",{\"key\":\"%s\",\"nonce\":\"0\",\"u64s\":%s}", hexbytes(zk,32).c_str(), u64s_json(z2).c_str());
        emit("],\n");
    }

    // Synthetic key material used by all PRF vectors below.
    SecKey sk;
    sm64_state = 0xA5A5;
    for (int i = 0; i < 4; i++) sk.prf_k[i] = sm64();
    sk.lpn_s_bits.resize(4096/64);
    for (auto& w : sk.lpn_s_bits) w = sm64();

    PubKey pk;                      // "pk-lite": only fields used by the PRF path
    pk.prm = Params{};
    pk.canon_tag = 0x123456789abcdef0ull;
    for (int i = 0; i < 32; i++) pk.H_digest[i] = (uint8_t)(i * 17 + 1);

    RSeed seed;
    seed.ztag = 0xfeedface12345678ull;
    seed.nonce.lo = 0x1020304050607080ull;
    seed.nonce.hi = 0x0807060504030201ull;

    // ---------------- derive_aes_key ----------------
    {
        emit("\"derive_aes_key\": [");
        const char* doms[] = {Dom::PRF_R1, Dom::PRF_R2, Dom::PRF_R3, Dom::TOEP, Dom::PRF_NOISE1};
        for (int i = 0; i < 5; i++) {
            uint8_t key[32]; uint64_t nonce;
            derive_aes_key(pk, sk, seed, doms[i], key, nonce);
            emit("%s{\"dom\":\"%s\",\"key\":\"%s\",\"nonce\":\"%llu\"}",
                 i?",":"", doms[i], hexbytes(key,32).c_str(), (unsigned long long)nonce);
        }
        emit("],\n");
        emit("\"prf_inputs\": {\"prf_k\":%s,\"lpn_s_bits\":%s,\"canon_tag\":\"%llu\","
             "\"H_digest\":\"%s\",\"ztag\":\"%llu\",\"nonce_lo\":\"%llu\",\"nonce_hi\":\"%llu\"},\n",
             u64s_json({sk.prf_k[0],sk.prf_k[1],sk.prf_k[2],sk.prf_k[3]}).c_str(),
             u64s_json(sk.lpn_s_bits).c_str(),
             (unsigned long long)pk.canon_tag,
             hexbytes(pk.H_digest.data(),32).c_str(),
             (unsigned long long)seed.ztag,
             (unsigned long long)seed.nonce.lo,
             (unsigned long long)seed.nonce.hi);
    }

    // ---------------- lpn_make_ybits (first 127 bits) + prf_R ----------------
    {
        std::vector<uint64_t> yb;
        lpn_make_ybits(pk, sk, seed, Dom::PRF_R1, yb);
        emit("\"lpn_ybits_r1_first2w\": %s,\n", u64s_json({yb[0], yb[1]}).c_str());

        Fp c1 = prf_R_core(pk, sk, seed, Dom::PRF_R1);
        Fp c2 = prf_R_core(pk, sk, seed, Dom::PRF_R2);
        Fp r  = prf_R(pk, sk, seed);
        Fp rn = prf_R_noise(pk, sk, seed);
        emit("\"prf_R_core_r1\": [\"%llu\",\"%llu\"],\n", (unsigned long long)c1.lo, (unsigned long long)c1.hi);
        emit("\"prf_R_core_r2\": [\"%llu\",\"%llu\"],\n", (unsigned long long)c2.lo, (unsigned long long)c2.hi);
        emit("\"prf_R\": [\"%llu\",\"%llu\"],\n", (unsigned long long)r.lo, (unsigned long long)r.hi);
        emit("\"prf_R_noise\": [\"%llu\",\"%llu\"],\n", (unsigned long long)rn.lo, (unsigned long long)rn.hi);

        Fp d0 = prf_noise_delta(pk, sk, seed, 0, 0);
        Fp d1 = prf_noise_delta(pk, sk, seed, 3, 1);
        emit("\"prf_noise_delta_g0k0\": [\"%llu\",\"%llu\"],\n", (unsigned long long)d0.lo, (unsigned long long)d0.hi);
        emit("\"prf_noise_delta_g3k1\": [\"%llu\",\"%llu\"],\n", (unsigned long long)d1.lo, (unsigned long long)d1.hi);
    }

    // ---------------- prg_choose_k ----------------
    {
        emit("\"prg_choose_k\": [");
        struct Case { int k, N; const char* label; std::vector<uint64_t> words; };
        std::vector<Case> cases = {
            {128, 16384, Dom::X_SEED, {pk.canon_tag, seed.ztag, seed.nonce.lo, seed.nonce.hi, 5, 1, 99}},
            {128, 8192,  Dom::NOISE,  {pk.canon_tag, seed.ztag, seed.nonce.lo, seed.nonce.hi, 5, 1, 99}},
            {192, 8192,  Dom::H_GEN,  {8192, 16384, 192, 0, pk.canon_tag}},
            {192, 8192,  Dom::H_GEN,  {8192, 16384, 192, 777, pk.canon_tag}},
            {48,  512,   Dom::H_GEN,  {512, 1024, 48, 3, 42}},
            {8,   337,   "pvac.test", {1, 2, 3}},
        };
        for (size_t i = 0; i < cases.size(); i++) {
            auto r = prg_choose_k(cases[i].k, cases[i].N, cases[i].label, cases[i].words);
            emit("%s{\"k\":%d,\"N\":%d,\"label\":\"%s\",\"words\":%s,\"out\":%s}",
                 i?",":"", cases[i].k, cases[i].N, cases[i].label,
                 u64s_json(cases[i].words).c_str(), ints_json(r).c_str());
        }
        emit("],\n");
    }

    // ---------------- gen_ubk_public ----------------
    {
        Ubk u = gen_ubk_public(0xCAFEBABEull, 512);
        emit("\"ubk_512\": {\"canon_tag\":\"3405691582\",\"perm\":%s},\n", ints_json(u.perm).c_str());
        Ubk u2 = gen_ubk_public(pk.canon_tag, 8192);
        std::vector<int> head(u2.perm.begin(), u2.perm.begin() + 32);
        uint64_t h = 0xcbf29ce484222325ull;
        for (int v : u2.perm) { h ^= (uint64_t)v; h *= 0x100000001b3ull; }
        emit("\"ubk_8192\": {\"head\":%s,\"fnv\":\"%llu\"},\n", ints_json(head).c_str(), (unsigned long long)h);
    }

    // ---------------- prg_layer_ztag ----------------
    {
        uint64_t z1 = prg_layer_ztag(pk.canon_tag, Nonce128{1, 2});
        uint64_t z2 = prg_layer_ztag(0, Nonce128{0, 0});
        emit("\"layer_ztag\": [\"%llu\",\"%llu\"],\n", (unsigned long long)z1, (unsigned long long)z2);
    }

    // ---------------- gen_H (small + default) ----------------
    {
        PubKey ps;
        ps.prm = small_params();
        ps.canon_tag = 0x777;
        gen_H(ps);
        emit("\"gen_H_small\": {\"canon_tag\":\"1911\",\"digest\":\"%s\",\"col0\":%s,\"col777\":%s},\n",
             hexbytes(ps.H_digest.data(),32).c_str(),
             u64s_json(ps.H[0].w).c_str(), u64s_json(ps.H[777].w).c_str());

        // sigma_from_H on the small pk
        BitVec s1 = sigma_from_H(ps, seed.ztag, seed.nonce, 5, 0, 99);
        BitVec s2 = sigma_from_H(ps, seed.ztag, seed.nonce, 5, 1, 99);
        BitVec s3 = sigma_from_H(ps, 0x42, Nonce128{7, 8}, 300, 0, 0);
        emit("\"sigma_small\": [%s,%s,%s],\n",
             u64s_json(s1.w).c_str(), u64s_json(s2.w).c_str(), u64s_json(s3.w).c_str());

        // ubk_apply / apply_perm_sigma on small
        Ubk us = gen_ubk_public(ps.canon_tag, ps.prm.m_bits);
        BitVec sp = apply_perm_sigma(s1, us.inv);
        emit("\"sigma_small_permuted\": %s,\n", u64s_json(sp.w).c_str());

        PubKey pd;
        pd.prm = Params{};
        pd.canon_tag = pk.canon_tag;
        gen_H(pd);
        emit("\"gen_H_default\": {\"digest\":\"%s\",\"col0_first8w\":%s},\n",
             hexbytes(pd.H_digest.data(),32).c_str(),
             u64s_json({pd.H[0].w[0],pd.H[0].w[1],pd.H[0].w[2],pd.H[0].w[3],
                        pd.H[0].w[4],pd.H[0].w[5],pd.H[0].w[6],pd.H[0].w[7]}).c_str());
    }

    // ---------------- field ops ----------------
    {
        emit("\"fp_ops\": [");
        sm64_state = 0xF00D;
        for (int i = 0; i < 24; i++) {
            Fp a = fp_from_words(sm64(), sm64());
            Fp b = fp_from_words(sm64(), sm64());
            Fp s = fp_add(a, b), d = fp_sub(a, b), m = fp_mul(a, b);
            Fp inv = (a.lo|a.hi) ? fp_inv(a) : fp_from_u64(0);
            Fp pw = fp_pow_u64(a, 0xABCDEF0123ull);
            emit("%s{\"a\":[\"%llu\",\"%llu\"],\"b\":[\"%llu\",\"%llu\"],"
                 "\"add\":[\"%llu\",\"%llu\"],\"sub\":[\"%llu\",\"%llu\"],"
                 "\"mul\":[\"%llu\",\"%llu\"],\"inv_a\":[\"%llu\",\"%llu\"],"
                 "\"pow_a\":[\"%llu\",\"%llu\"]}",
                 i?",":"",
                 (unsigned long long)a.lo,(unsigned long long)a.hi,
                 (unsigned long long)b.lo,(unsigned long long)b.hi,
                 (unsigned long long)s.lo,(unsigned long long)s.hi,
                 (unsigned long long)d.lo,(unsigned long long)d.hi,
                 (unsigned long long)m.lo,(unsigned long long)m.hi,
                 (unsigned long long)inv.lo,(unsigned long long)inv.hi,
                 (unsigned long long)pw.lo,(unsigned long long)pw.hi);
        }
        emit("],\n");
        // fp_from_words edge cases: values >= p, high bit set
        emit("\"fp_from_words_cases\": [");
        uint64_t cases[][2] = {
            {UINT64_MAX, UINT64_MAX},          // full 128 bits
            {UINT64_MAX, MASK63},              // exactly p
            {0, 0x8000000000000000ull},        // bit 127 set
            {1234, MASK63},                    // p - something + ...
            {UINT64_MAX - 1, MASK63},          // p - 1
        };
        for (int i = 0; i < 5; i++) {
            Fp f = fp_from_words(cases[i][0], cases[i][1]);
            emit("%s{\"in\":[\"%llu\",\"%llu\"],\"out\":[\"%llu\",\"%llu\"]}",
                 i?",":"",
                 (unsigned long long)cases[i][0],(unsigned long long)cases[i][1],
                 (unsigned long long)f.lo,(unsigned long long)f.hi);
        }
        emit("],\n");
    }

    // ---------------- toep_127 ----------------
    {
        emit("\"toep_127\": [");
        sm64_state = 0xBEEF;
        for (int i = 0; i < 8; i++) {
            std::vector<uint64_t> top(258), y(256);
            for (auto& q : top) q = sm64();
            for (auto& q : y) q = sm64();
            uint64_t lo, hi;
            toep_127_scalar(top, y, lo, hi);
            emit("%s{\"top2\":%s,\"y2\":%s,\"lo\":\"%llu\",\"hi\":\"%llu\"}",
                 i?",":"", u64s_json({top[0],top[1]}).c_str(), u64s_json({y[0],y[1]}).c_str(),
                 (unsigned long long)lo, (unsigned long long)hi);
        }
        emit("],\n");
    }

    // ---------------- commit_ct ----------------
    {
        Cipher C;
        Layer L0; L0.rule = RRule::BASE; L0.seed.ztag = 11; L0.seed.nonce = {22, 33};
        Layer L1; L1.rule = RRule::BASE; L1.seed.ztag = 44; L1.seed.nonce = {55, 66};
        Layer L2; L2.rule = RRule::PROD; L2.pa = 0; L2.pb = 1; L2.seed.ztag = 0; L2.seed.nonce = {0,0};
        C.L = {L0, L1, L2};
        BitVec bv = BitVec::make(512);
        bv.w[0] = 0x123456789abcdef0ull; bv.w[3] = 7;
        C.E.push_back(Edge{0, 5, 0, fp_from_u64(42), bv});
        C.E.push_back(Edge{2, 300, 1, fp_from_words(123, 456), bv});
        auto cm = commit_ct(pk, C);
        emit("\"commit_ct\": \"%s\",\n", hexbytes(cm.data(), 32).c_str());
    }

    // ---------------- fnv1a domain hashes ----------------
    {
        emit("\"fnv1a\": {");
        const char* doms[] = {Dom::H_GEN, Dom::X_SEED, Dom::NOISE, Dom::PRF_LPN, Dom::TOEP,
                              Dom::ZTAG, Dom::COMMIT, Dom::PRF_R1, Dom::PRF_R2, Dom::PRF_R3,
                              Dom::PRF_NOISE1, Dom::PRF_NOISE2, Dom::PRF_NOISE3};
        for (int i = 0; i < 13; i++) {
            emit("%s\"%s\":\"%llu\"", i?",":"", doms[i], (unsigned long long)fnv1a_domain(doms[i]));
        }
        emit("},\n");
    }

    emit("\"ok\": true\n}\n");
    fclose(out);
    fprintf(stderr, "vectors.json written\n");
    return 0;
}
