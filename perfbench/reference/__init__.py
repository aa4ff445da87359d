"""The plain references of the benchmark's configurations, one module each.

A configuration names its module with ``"reference": "<module>"``
(``reference/<module>.py``; default ``model``), and ``check.run_check`` and
``control.py`` take it only through ``spec.reference``. A module imports
nothing of the program or of ``perfbench`` outside this package (a
sibling by relative import, such as ``model.py``'s blocks and ``Alg3``),
and defines:

- ``Reference(params, config, precision="f32")``: ``params`` the tree of
  weights the program was handed too, ``config`` the configuration file's
  object, ``precision`` ``"f32"`` (the reference), ``"fp8"`` (the control)
  or ``"bf16"`` (a witness); it raises for a policy or a layer it does not
  follow;
- ``Reference.run(prompt, served, padded_len, follow=None) -> Result``:
  ``prompt`` (n,) token ids, ``served`` (T + 1,) the tokens the program
  served, ``padded_len`` the row's length as the program ran it;
  ``follow``, per paged layer, the (logical slots, head) the decode starts
  from instead of the reference's own selection (each slot a list of
  positions or None);
- ``Result(logits, layers)``: ``logits`` (T + 1, vocab) f32, of the last
  prompt token and of each decode step; ``layers`` one entry per paged
  (attention) layer, in depth order, with ``kept`` (the positions Alg. 2
  keeps, ascending), ``scores`` (n + T,) the token scores by position,
  ``start`` the (slots, head) the decode started from and ``final`` the
  set of live positions after it. A layer without pages (a recurrent
  mixer) has no entry, as the program's ``Snapshot`` lists none.
"""
