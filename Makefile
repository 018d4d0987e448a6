# Convenience targets (the reference exposes make / make test,
# /root/reference/Makefile:1-32; the Python package itself needs no build
# beyond its native runtime library).

.PHONY: all native test bench baseline clean

all: native

native:
	$(MAKE) -s -C ngsdist_jax/native

test: native
	python -m pytest tests/ -q

bench:
	python bench.py

baseline:
	python tests/refharness/measure_cpu_baseline.py

clean:
	rm -rf ngsdist_jax/native/build tests/refharness/build
