// Golden interop fixture generator.
//
// Runs the READ-ONLY reference implementation (headers at
// /root/reference/include) end-to-end with default and small Params, and
// writes key material + ciphertexts + expected plaintexts to
// tests/golden/{default,small}/. The JAX framework must load these
// and decrypt to the expected values bit-for-bit.
#include <pvac/pvac.hpp>
#include <pvac/utils/text.hpp>
#include "hser.hpp"
#include <cstdio>
#include <sys/stat.h>

using namespace pvac;

static void gen_set(const Params& prm, const std::string& dir) {
    mkdir(dir.c_str(), 0755);
    PubKey pk; SecKey sk;
    keygen(prm, pk, sk);

    uint64_t a = 42, b = 17;
    Cipher ca = enc_value(pk, sk, a);
    Cipher cb = enc_value(pk, sk, b);
    Cipher csum = ct_add(pk, ca, cb);
    Cipher cdiff = ct_sub(pk, ca, cb);
    Cipher cprod = ct_mul(pk, ca, cb);
    Cipher cscale = ct_scale(pk, ca, fp_from_u64(1000));
    Cipher czero = enc_zero_depth(pk, sk, 1);

    EvalKey ek = make_evalkey(pk, sk, 4, 0);
    Cipher crec = ct_recrypt(pk, ek, csum);

    auto text_cts = enc_text(pk, sk, "hello pvac on tpu!");

    hser::save_pklite(pk, dir + "/pklite.bin");
    hser::save_sk(sk, dir + "/sk.bin");
    hser::save_cts({ca}, dir + "/a.ct");
    hser::save_cts({cb}, dir + "/b.ct");
    hser::save_cts({csum}, dir + "/sum.ct");
    hser::save_cts({cdiff}, dir + "/diff.ct");
    hser::save_cts({cprod}, dir + "/prod.ct");
    hser::save_cts({cscale}, dir + "/scale1000.ct");
    hser::save_cts({czero}, dir + "/zero.ct");
    hser::save_cts({crec}, dir + "/recrypt_sum.ct");
    hser::save_cts(text_cts, dir + "/text.ct");

    // Self-check with the reference and record expectations.
    Fp da = dec_value(pk, sk, ca);
    Fp db = dec_value(pk, sk, cb);
    Fp ds = dec_value(pk, sk, csum);
    Fp dd = dec_value(pk, sk, cdiff);
    Fp dp = dec_value(pk, sk, cprod);
    Fp dsc = dec_value(pk, sk, cscale);
    Fp dz = dec_value(pk, sk, czero);
    Fp dr = dec_value(pk, sk, crec);
    std::string txt = dec_text(pk, sk, text_cts);

    if (da.lo != a || db.lo != b || ds.lo != a + b || dp.lo != a * b ||
        dsc.lo != a * 1000 || (dz.lo | dz.hi) != 0 || dr.lo != a + b ||
        txt != "hello pvac on tpu!") {
        fprintf(stderr, "SELF-CHECK FAILED for %s\n", dir.c_str());
        exit(1);
    }
    // diff = a - b = 25 (a > b)
    if (dd.lo != a - b || dd.hi != 0) { fprintf(stderr, "diff self-check fail\n"); exit(1); }

    FILE* f = fopen((dir + "/expected.json").c_str(), "w");
    fprintf(f, "{\"a\": 42, \"b\": 17, \"sum\": 59, \"diff\": 25, \"prod\": 714,\n"
               " \"scale1000\": 42000, \"zero\": 0, \"recrypt_sum\": 59,\n"
               " \"text\": \"hello pvac on tpu!\"}\n");
    fclose(f);
    fprintf(stderr, "wrote %s (a.ct edges=%zu layers=%zu, prod edges=%zu layers=%zu)\n",
            dir.c_str(), ca.E.size(), ca.L.size(), cprod.E.size(), cprod.L.size());
}

int main() {
    Params def;
    gen_set(def, "tests/golden/default");

    Params small;
    small.m_bits = 512;
    small.n_bits = 1024;
    small.h_col_wt = 48;
    small.x_col_wt = 32;
    small.err_wt = 32;
    small.lpn_n = 256;
    small.lpn_t = 1024;
    gen_set(small, "tests/golden/small");
    return 0;
}
