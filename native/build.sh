#!/bin/sh
# Build the native host library (f64 KKT oracle, rollout validation).
# Compiles to a private temporary name and renames it into place, so
# processes that build concurrently never load a half-written library.
set -e
cd "$(dirname "$0")"
tmp="libqct_native.so.tmp.$$"
g++ -O3 -fPIC -shared -std=c++17 -o "$tmp" qct_native.cpp
mv -f "$tmp" libqct_native.so
echo "built $(pwd)/libqct_native.so"
