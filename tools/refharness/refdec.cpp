// Reference-side decoder: decrypts .ct files (bounty/VER-1 format) using the
// READ-ONLY reference implementation, given a pk-lite + sk. Used by the test
// suite to prove that ciphertexts produced by the JAX framework are
// decryptable by the original C++ implementation (interop in the reverse
// direction of gen_golden).
//
// Usage: refdec <pklite.bin> <sk.bin> <file.ct>
//   Prints one line per cipher in the file: "<lo> <hi>"
#include <pvac/pvac.hpp>
#include "hser.hpp"
#include <cstdio>

using namespace pvac;

int main(int argc, char** argv) {
    if (argc != 4) { fprintf(stderr, "usage: refdec pklite sk ct\n"); return 2; }
    PubKey pk = hser::load_pklite(argv[1]);
    SecKey sk = hser::load_sk(argv[2]);
    auto cts = hser::load_cts(argv[3]);
    for (const auto& c : cts) {
        Fp v = dec_value(pk, sk, c);
        printf("%llu %llu\n", (unsigned long long)v.lo, (unsigned long long)v.hi);
    }
    return 0;
}
