# Developer entry points — `make check` is the gate every change must
# pass, mirroring the reference's push-time CI (cpp-library.yml runs its
# catch suite under valgrind on every push; here: the full pytest suite
# on the CPU mesh plus the ASan rebuild of the native extensions).

PY ?= python

.PHONY: ext test memcheck bench check chip-smoke docs

ext:
	$(PY) setup.py build_ext --inplace

test: ext
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

memcheck: ext
	./scripts/check_native.sh

bench: ext
	$(PY) bench.py

check: test memcheck
	@echo "check OK"

# On-card gate (needs an NVIDIA GPU): every device route of the CLI at
# full size, byte-compared vs the C++ baseline (builds the extensions
# itself).  `python chip_smoke.py --four` runs the 4-card paths.
chip-smoke:
	$(PY) chip_smoke.py

# The reference regenerates docs/cli.rst by running `./humid -h`
# (src/Makefile:49-50); same idea here.
docs:
	JAX_PLATFORMS=cpu $(PY) -m humid_tpu -h > docs/cli-help.txt
