"""TT kernel stack: hand-written Hopper kernels (``tt_contract``), their
plain versions (``ref``), the plan resolver (``plan``) and the executor
(``ops.tt_forward``)."""
