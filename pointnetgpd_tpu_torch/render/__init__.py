"""Offscreen rendering: virtual cameras over viewsphere pose grids, through
the repository's C++ software rasterizer (``native/renderer/renderer.cpp``,
built by ``render/native.py`` into the port's ``_build/``). Port of
``pointnetgpd_tpu/render``."""
