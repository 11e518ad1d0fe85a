"""paddle_tpu_torch.framework (counterpart of ``paddle_tpu/framework``).

Ported so far: :mod:`.custom_op`, the custom-operator plugin surface
(``register_op``, ``load_op_library``), :mod:`.io` (``save`` / ``load``
in the reference's pickle schema) and :mod:`.random` (``seed``).  The
dtype and state modules wait for the eager ``paddle.*`` tensor substrate.
"""
