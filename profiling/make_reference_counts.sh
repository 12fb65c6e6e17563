#!/usr/bin/env bash
# Regenerate every reference-binary oracle pinned in this repo:
#   - tests/test_reference_parity.py REFERENCE_COUNTS /
#     COMPLEX_REFERENCE_COUNTS / COMPLEX10K_REFERENCE_COUNTS
#   - bench_baseline.json (case_10K CG wall, Laplacian 128^3 CG x100 wall)
#
# Builds the reference library's NATIVE backend unmodified from
# /root/reference/src/lib (the tree is read-only, so sources are copied to
# a gitignored scratch dir with a native-only config.h — this host has no
# Eigen3/CUDA), compiles profiling/reference_counts.cpp against it, and
# runs it on the shipped data/case_* systems.
#
# Usage:  profiling/make_reference_counts.sh [--quick]
#   --quick: single repetition, skip the ~4 s Laplacian wall workload
#            (counts only).
# Output:  JSON on stdout; also written to profiling/reference_counts.json
#          (full mode only).
#
# NOTE: the Laplacian workload loads all 4 host cores; do not time
# anything else on the host while it runs.

set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
REF=/root/reference
BUILD="$REPO/build/ref_counts"
QUICK="${1:-}"

mkdir -p "$BUILD/lib"

# Native backend sources only (lcg/clcg + algebra + complex + util); the
# Eigen/CUDA siblings need libraries this host doesn't have.  config.h is
# regenerated (the shipped one enables LibLCG_EIGEN).
# cp -p preserves source mtimes so the -nt object cache below actually
# hits (a plain cp stamps dest mtime = now and forces a full rebuild on
# every invocation — measured as a constant ~7 s tax per test-suite run).
for f in lcg.h lcg.cpp clcg.h clcg.cpp algebra.h algebra.cpp \
         lcg_complex.h lcg_complex.cpp util.h util.cpp; do
  cp -p "$REF/src/lib/$f" "$BUILD/lib/"
done
cat > "$BUILD/lib/config.h" <<'EOF'
#define LibLCG_OPENMP
#define LibLCG_STD_COMPLEX
EOF

CXXFLAGS="-O3 -fopenmp -std=c++11 -I$BUILD/lib"
for src in lcg clcg algebra lcg_complex util; do
  obj="$BUILD/$src.o"
  if [ ! -f "$obj" ] || [ "$BUILD/lib/$src.cpp" -nt "$obj" ]; then
    g++ $CXXFLAGS -c "$BUILD/lib/$src.cpp" -o "$obj"
  fi
done
BIN="$BUILD/reference_counts"
if [ ! -f "$BIN" ] || [ "$REPO/profiling/reference_counts.cpp" -nt "$BIN" ] \
   || [ "$BUILD/lcg.o" -nt "$BIN" ]; then
  g++ $CXXFLAGS "$REPO/profiling/reference_counts.cpp" \
      "$BUILD"/{lcg,clcg,algebra,lcg_complex,util}.o -o "$BIN"
fi

if [ "$QUICK" = "--quick" ]; then
  "$BIN" "$REF/data" --quick
else
  "$BIN" "$REF/data" | tee "$REPO/profiling/reference_counts.json"
fi
