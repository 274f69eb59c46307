"""Command-line entry points of the port: serving (``run_pipeline_eval``,
``predict_trees``), the threshold and report tools, the dataset tool
``prepare_stage3``, and the trainers ``train_stage1``, ``train_stage2``,
``train_stage3``, ``train_stage2_flat`` and ``train_unified``."""
