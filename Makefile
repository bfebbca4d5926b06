# One-command gates, mirroring the reference Makefile (reference:
# Makefile:1-21 — run_release / fmt / clippy / test / ci).

PY_SOURCES = raytracer2022_tpu raytracer2022_tpu_torch tests tools bench.py __graft_entry__.py chip_smoke.py compare_k1.py

.PHONY: run run-torch fmt lint test test-full bench bench-torch smoke ci native

run:
	python -m raytracer2022_tpu.cli --scene wwscene --width 640 --height 360 --spp 100 --out output/output.jpg

# the same render with the PyTorch port, on the CUDA card
run-torch:
	python -m raytracer2022_tpu_torch.cli --scene wwscene --width 640 --height 360 --spp 100 --out output/output.jpg

fmt:
	ruff format $(PY_SOURCES)

# local images may lack ruff; degrade to a syntax gate (CI always runs ruff)
lint:
	@if python -c "import ruff" 2>/dev/null; then \
		python -m ruff check $(PY_SOURCES); \
	else \
		python -m compileall -q $(PY_SOURCES) && echo "compileall ok (ruff unavailable)"; \
	fi

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

# the full battery including @slow statistical cross-checks (nightly gate)
test-full:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m ""

bench:
	python bench.py

# bench.py's cells with the PyTorch port, on the CUDA card
bench-torch:
	python -m raytracer2022_tpu_torch.tools.bench

# the port on one CUDA card: builds K1, drives every path, checks it
smoke:
	python3 chip_smoke.py

native:
	$(MAKE) -C native

# the reference's `make ci` = fmt-check + clippy + test + release run
ci: lint test
	@echo CI gate passed
