"""paddle_tpu_torch.framework (counterpart of ``paddle_tpu/framework``).

Ported so far: :mod:`.custom_op`, the custom-operator plugin surface
(``register_op``, ``load_op_library``).  The dtype, random, state and io
modules wait for the eager ``paddle.*`` tensor substrate.
"""
