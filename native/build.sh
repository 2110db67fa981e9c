#!/bin/sh
# Build the native runtime components. The library is written under a
# temporary name and renamed into place, so processes that build at the
# same time never load a half-written file.
set -e
cd "$(dirname "$0")"
g++ -O3 -fPIC -shared -std=c++17 -o "libtumloader.so.$$" tum_loader.cpp -lz -lpthread
mv -f "libtumloader.so.$$" libtumloader.so
echo "built native/libtumloader.so"
