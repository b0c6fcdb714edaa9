"""Native (C++/OpenMP) host kernels: the threshold-mixture sweep."""
