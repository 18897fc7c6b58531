"""Hardware constants of the roofline model (``hw.HwSpec``): the H100 the
port runs on, and the JAX package's TPU v5e kept as it cites it."""
