from .sql import parse_sql_expr, Expr
from .eval import evaluate_predicate_mask, evaluate_expression, referenced_columns

__all__ = [
    "parse_sql_expr",
    "Expr",
    "evaluate_predicate_mask",
    "evaluate_expression",
    "referenced_columns",
]
