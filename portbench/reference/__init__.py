"""The plain reference renderer: a frozen copy of svgf_tpu_torch's plain
route for the scenes the benchmark makes (matte materials, area lights, no
environment, textures or media): G-buffer, the 1-spp MIS path tracer with
its host threefry keys and lowbias32 draws, and the four SVGF stages.

Plain PyTorch and NumPy. It imports nothing of svgf_tpu_torch, takes no
array the program made, and builds its own world soup, light CDF and
acceleration structure from the benchmark's scene description.
"""
