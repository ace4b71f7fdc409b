"""The host image codec in C++ (``fastimage.cpp``: PNG row filters, Pillow's
resize, flip and normalisation in one pass; ``jpeg.cpp``: a baseline and
progressive JPEG decoder; ``webp.cpp``: a lossy (VP8) and lossless (VP8L) WebP
decoder), built with g++ on first use and bound with ctypes (:mod:`.build`).
Nothing is built when this package is imported."""
