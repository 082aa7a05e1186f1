"""Float64 NumPy oracle — test-only golden implementation of the KLT spec.

See klt_oracle.py (selection/tracking) and affine_oracle.py (affine
consistency check). Never imported by the production device path.
"""
