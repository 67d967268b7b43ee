# Developer convenience targets (reference: the per-test Makefile rules).

PY ?= python

.PHONY: test test-v test-q test-slow test-all test-gpu bench smoke smoke-four \
        native golden vectors multihost clean

test:
	$(PY) -m pytest tests/ -q

# full tier incl. slow tests (timing uniformity, default-params H digest,
# depth-3 squaring)
test-all:
	$(PY) -m pytest tests/ -q -m ""

# tests that need the card (marker `gpu`)
test-gpu:
	JAX_PLATFORMS=cuda,cpu $(PY) -m pytest tests/ -q -m gpu

# the device engine's main path on one GPU / the mesh path on four
smoke:
	$(PY) chip_smoke.py

smoke-four:
	$(PY) chip_smoke.py --four

test-v:
	PVAC_DBG=1 $(PY) -m pytest tests/ -v

test-q:
	$(PY) -m pytest tests/ -q -x

test-slow:
	$(PY) -m pytest tests/ -q -m slow

bench:
	$(PY) bench.py

bench-quick:
	PVAC_BENCH_QUICK=1 $(PY) bench.py

native:
	$(PY) -c "from pvac_hfhe_cppbyv_tpu import native; assert native.lib()"

# TRUE multi-process distributed-backend validation: two OS processes,
# jax.distributed, one global (dp=2, tp=4) mesh; psum/sigma collectives
# cross the process boundary; bit-exact vs host in both processes.
multihost:
	$(PY) tools/multihost_cpu.py

# ASan/UBSan build of the native runtime + the tests that exercise it
# (parity with the reference's `make sanitize`, Makefile:24-25)
sanitize:
	PVAC_NATIVE_SANITIZE=1 \
	LD_PRELOAD=$$(g++ -print-file-name=libasan.so) \
	ASAN_OPTIONS=detect_leaks=0 \
	$(PY) tools/native_selftest.py

debug:
	PVAC_DBG=2 $(PY) -m pytest tests/test_scheme.py -q

# Regenerate reference-derived fixtures (needs g++ + /root/reference)
vectors:
	mkdir -p build tests/golden
	g++ -std=c++17 -O2 -march=native -I/root/reference/include \
	    -o build/dump_vectors tools/refharness/dump_vectors.cpp
	./build/dump_vectors

golden:
	mkdir -p build tests/golden
	g++ -std=c++17 -O2 -march=native -I/root/reference/include \
	    -o build/gen_golden tools/refharness/gen_golden.cpp
	./build/gen_golden

clean:
	rm -rf build .pytest_cache pvac_metrics.csv
	find . -name __pycache__ -type d -exec rm -rf {} +
