CXX ?= g++
CXXFLAGS ?= -O3 -std=c++20 -fPIC -Wall -Wextra
NATIVE_SO := stock_market_monte_carlo_tpu/native/libsmmc_native.so
# the PyTorch port's copy (stock_market_monte_carlo_torch/native loads it)
NATIVE_TORCH_SO := build/torch_kernels/libsmmc_native.so

.PHONY: all native test bench clean

all: native

native: $(NATIVE_SO) $(NATIVE_TORCH_SO)

$(NATIVE_SO): csrc/smmc_native.cpp
	$(CXX) $(CXXFLAGS) -shared -o $@ $<

$(NATIVE_TORCH_SO): csrc/smmc_native.cpp
	mkdir -p $(dir $@)
	$(CXX) $(CXXFLAGS) -shared -o $@ $<

test:
	python -m pytest tests/ -x -q

bench:
	python bench.py

clean:
	rm -f $(NATIVE_SO) $(NATIVE_TORCH_SO)
