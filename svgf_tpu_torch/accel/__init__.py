from svgf_tpu_torch.accel.bvh import BLAS, build_blas, build_tlas, flatten_blases, FlatBVH

__all__ = ["BLAS", "build_blas", "build_tlas", "flatten_blases", "FlatBVH"]
