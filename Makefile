# Build / test / bench entry points.

.PHONY: all native test test-gpu bench clean

all: native

# build/libspsp_native-<key>.so, keyed on csrc/, flags and host CPU
native:
	python -c "from supersampler_tpu.native import get_lib; assert get_lib() is not None, 'native build failed'"

test: native
	python -m pytest tests/ -x -q

# the tests that need an NVIDIA GPU (skipped elsewhere)
test-gpu: native
	SPSP_TEST_PLATFORM=gpu python -m pytest tests/ -q -m gpu

bench: native
	python bench.py

clean:
	rm -rf build/*.so
