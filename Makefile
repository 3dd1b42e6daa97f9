# Convenience targets (the package itself needs no build step: the native
# C++ extension auto-compiles with g++ -O3 -march=native on first import,
# stamped by its sources, flags and the host CPU).

PY ?= python
CPU_MESH = JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

.PHONY: test fuzz bench bench-all chip-smoke chip-smoke-four scaling dryrun clean

test:
	$(CPU_MESH) $(PY) -m pytest tests/ -x -q

fuzz:
	$(PY) scripts/fuzz_sharded.py 40
	$(PY) scripts/fuzz_modutils.py 20
	$(PY) scripts/fuzz_modasm.py 12
	$(PY) scripts/fuzz_modmap.py 10
	$(PY) scripts/fuzz_modrep.py 8
	$(PY) scripts/fuzz_cram.py 6
	$(PY) scripts/fuzz_sequtils.py 20
	$(PY) scripts/fuzz_modtype.py 8

bench:          # modset build on one GPU, checked vs the host oracle (fails without a GPU)
	$(PY) bench.py

chip-smoke:     # one GPU: every device path vs the host oracle (fails without a GPU)
	$(PY) chip_smoke.py

chip-smoke-four: # four GPUs: sharded build, merge and lookup vs the host oracle
	$(PY) chip_smoke.py --four

bench-all:      # all five BASELINE configs, host path vs the compiled C reference
	$(PY) bench_all.py

native-cli:     # C++ modutils fast path (bin/modutils-native)
	$(PY) -c "from modimizer.native import build_cli; \
	    import sys; sys.exit(0 if build_cli(force=True) else 1)"

scaling:        # multi-GPU weak scaling of the sharded build (fails without GPUs)
	$(PY) bench_scaling.py

dryrun:         # multi-chip sharding compile+run on a virtual 8-device mesh
	$(CPU_MESH) $(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

clean:
	rm -rf modimizer/native/_build .pycache .jax_cache .smoke_work
