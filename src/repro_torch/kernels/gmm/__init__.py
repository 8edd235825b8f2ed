"""Device-side tile packing of runtime patterns (the grouped dynamic
routes).  The routes run the dsmm kernel on the packed tiles, so their
contract is ``kernels/dsmm``'s; the reference's ``gmm`` kernel itself
(expert-grouped GEMM) is not ported yet."""
