"""LM steps and loops: serving (``serve_step``), the train step
(``train_step``) and the fault-tolerant loop (``loop``)."""
