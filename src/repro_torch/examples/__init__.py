"""The port's examples: ``python -m repro_torch.examples.<name>``.

Counterparts of the reference's ``examples/*.py``.  Each module has
``main(argv=None) -> dict``: it parses ``argv``, prints what the
reference's example prints and returns the numbers it printed.  Each runs
on the CUDA device unless ``--device cpu`` is given (then on the plain
PyTorch versions of the kernels), and raises without a card otherwise.

* ``quickstart`` — the dense path and the event path of ``tiny_net`` on
  one sample, bitwise equal, mapped onto the SNE energy model;
* ``event_sparsity`` — energy against events over thinned input streams,
  and sigma-delta gated RG-LRU decode over thresholds;
* ``train_dvs_gesture`` — surrogate-gradient training (``--scale tiny``,
  ``nmnist`` or ``full``, the Fig. 6 network), then the quantised event
  path on held-out samples;
* ``serve_events`` — the slot-batched event engine under any execution
  policy, synchronous or streaming, on synthetic streams or a replayed
  recording;
* ``serve_lm`` — an LM smoke config on the slot-batched LM engine.
"""
