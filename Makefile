# Tier-1 verification and common dev entry points.
PY ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))

.PHONY: test test-fast test-dynamic test-resilience lint-dispatch analyze analyze-kernels analyze-torch analyze-baseline check bench bench-smoke bench-check serve-apsp serve-dynamic serve-chaos serve-chaos-correlated

test:           ## tier-1: the whole suite, fail fast
	$(PY) -m pytest -x -q

test-fast:      ## smoke path: skip slow subprocess tests and O(n^3) oracle sweeps
	$(PY) -m pytest -x -q -m "not slow and not oracle"

test-dynamic:   ## incremental-engine differential suite (update vs full recompute)
	$(PY) -m pytest -x -q -m dynamic

test-resilience:  ## serving-tier fault-tolerance suite (chaos, lifecycle, eviction)
	$(PY) -m pytest -x -q -m resilience

lint-dispatch:  ## back-compat alias: the unfused-dispatch check alone (see analyze)
	$(PY) tools/lint_dispatch.py

analyze:        ## full invariant sweep: AST checkers + donation sanitizer + kernel grid verifier
	$(PY) tools/analyze.py

analyze-kernels:  ## concolic Pallas grid verifier alone (race/bounds/coverage/padding proofs)
	$(PY) tools/analyze.py --only kernel-grid

analyze-torch:  ## the PyTorch port's invariant checkers over src/repro_torch (CUDA half on a card)
	$(PY) -m repro_torch.analysis

analyze-baseline:  ## regenerate the committed machine-readable clean baseline
	$(PY) tools/analyze.py --json > ANALYZE_baseline.json

check: analyze  ## invariant sweep + tier-1 (incl. dynamic suite) + oracle suite + chaos smoke + bench gate
	$(PY) -m pytest -x -q -m "not oracle"
	$(PY) -m pytest -q -m oracle tests/test_semiring_oracle.py
	$(MAKE) serve-chaos
	$(MAKE) serve-chaos-correlated
	$(MAKE) bench-check

bench:          ## paper-figure benchmark sweep (CSV to stdout + BENCH_apsp.json)
	$(PY) -m benchmarks.run --quick

bench-smoke:    ## autotuner + benchmark dispatch-regression canary at N<=128 (seconds)
	$(PY) -m benchmarks.run --smoke --json BENCH_apsp_smoke.json

bench-check:    ## regression gate: median-of-3 fresh smoke vs committed baseline (noise-tolerant)
	$(PY) tools/bench_compare.py

serve-apsp:     ## smoke the batched APSP serving loop
	$(PY) -m repro.launch.serve --arch apsp --requests 32 --batch 16 --n-max 64

serve-dynamic:  ## smoke the incremental (edge-update) serving loop
	$(PY) -m repro.launch.serve --arch apsp --requests 32 --n-max 64 \
		--mutate-rate 0.5 --graphs 2 --verify-every 8

serve-chaos:    ## chaos smoke: seeded faults, zero poisoned answers, full recovery (non-zero exit on drift)
	$(PY) -m repro.launch.serve --arch apsp --requests 48 --n-max 32 \
		--mutate-rate 0.5 --graphs 3 --mutate-k 4 --verify-every 12 --seed 7 \
		--fault-spec "nan:0.15,crash:0.1:3,latency:0.1:10,poison:0.1,mem:0.15:0.5" \
		--deadline-ms 100 --mem-budget-mb 0.008 --backlog-watermark 4

serve-chaos-correlated:  ## correlated chaos smoke: async executor + durable slots under backend loss, cache storms, crash-restore drills
	$(PY) -m repro.launch.serve --arch apsp --requests 48 --n-max 32 \
		--mutate-rate 0.5 --graphs 3 --mutate-k 4 --verify-every 12 --seed 7 \
		--async-updates --durability-dir auto --checkpoint-every 2 \
		--fault-spec "backend_loss:0.2:4,cache_storm:0.2:4,crash_restore:0.25,latency:0.05:5" \
		--backlog-watermark 8
